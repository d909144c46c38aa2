"""Checkpointing (counterpart of ``repro.checkpoint``): atomic npz-tree
checkpoints (tmp + ``os.replace``), retention, and an async writer so the
train loop never blocks on disk.  The keys are the reference's, so a
checkpoint written by either package restores in the other.
"""

from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          restore, save)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
