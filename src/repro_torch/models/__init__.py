"""Model specs (counterpart of ``repro.models``): the paper nets."""
