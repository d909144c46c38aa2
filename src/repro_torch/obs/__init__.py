"""Observability (counterpart of ``repro.obs``): serving metrics only."""
