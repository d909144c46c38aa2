"""Optimizers (counterpart of ``repro.optim``): AdamW and SGD with
momentum, global-norm clipping, the cosine schedule, and the STE-aware
clipping of latent weights for binarized layers.  The state trees mirror
the parameter tree.
"""

from repro_torch.optim.optimizers import (OptState, adamw_init, adamw_update,
                                          clip_by_global_norm,
                                          cosine_schedule, global_norm,
                                          sgdm_init, sgdm_update)

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "sgdm_init", "sgdm_update"]
