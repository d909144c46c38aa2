"""vit-l16 [arXiv:2010.11929; paper] — ViT-L/16.

img_res=224 patch=16 24L d_model=1024 16H (head 64) d_ff=4096.  The same
FULL and SMOKE as ``repro.configs.vit_l16``.
PhoneBit technique: QKV/MLP dense projections binarize (binary variant).
"""

from repro_torch.configs.shapes import VISION_SHAPES
from repro_torch.models.vit import ViTConfig

FAMILY = "vision"
SHAPES = VISION_SHAPES

FULL = ViTConfig(
    name="vit-l16", img_res=224, patch=16, n_layers=24, d_model=1024,
    n_heads=16, d_ff=4096, pos_grid=14,
)

SMOKE = ViTConfig(
    name="vit-smoke", img_res=32, patch=8, n_layers=2, d_model=32,
    n_heads=4, d_ff=64, n_classes=10, pos_grid=4,
)
