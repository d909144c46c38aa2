"""dit-xl2 [arXiv:2212.09748; paper] — DiT-XL/2.

img_res=256 (latent 32²×4), patch=2, 28L d_model=1152 16H (head 72, K7's
padded width).  The same FULL and SMOKE as ``repro.configs.dit_xl2``.
``remat_policy="dots"`` acts, as in DiT-L/2; ``seq_shard``, a multi-chip
setting, is kept so the configs read alike and unread on one card.
"""

from repro_torch.configs.shapes import DIFFUSION_SHAPES
from repro_torch.models.dit import DiTConfig

FAMILY = "diffusion"
SHAPES = DIFFUSION_SHAPES

FULL = DiTConfig(
    name="dit-xl2", img_res=256, patch=2, n_layers=28, d_model=1152,
    n_heads=16, seq_shard=True, remat_policy="dots",
)

SMOKE = DiTConfig(
    name="dit-xl-smoke", img_res=64, patch=2, n_layers=2, d_model=48,
    n_heads=4, n_classes=10,
)
