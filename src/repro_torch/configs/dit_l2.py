"""dit-l2 [arXiv:2212.09748; paper] — DiT-L/2.

img_res=256 (latent 32²×4), patch=2, 24L d_model=1024 16H (head 64).  The
same FULL and SMOKE as ``repro.configs.dit_l2``.  ``remat_policy="dots"``
acts: each layer of a train step keeps its matrix products' outputs and
recomputes the rest.  ``seq_shard`` is the reference's multi-chip
setting, kept so the configs read alike and unread on one card.
"""

from repro_torch.configs.shapes import DIFFUSION_SHAPES
from repro_torch.models.dit import DiTConfig

FAMILY = "diffusion"
SHAPES = DIFFUSION_SHAPES

FULL = DiTConfig(
    name="dit-l2", img_res=256, patch=2, n_layers=24, d_model=1024,
    n_heads=16, seq_shard=True, remat_policy="dots",
)

SMOKE = DiTConfig(
    name="dit-smoke", img_res=64, patch=2, n_layers=2, d_model=64,
    n_heads=4, n_classes=10,
)
