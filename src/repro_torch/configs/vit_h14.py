"""vit-h14 [arXiv:2010.11929; paper] — ViT-H/14.

img_res=224 patch=14 32L d_model=1280 16H (head 80, K7's padded width)
d_ff=5120.  The same FULL and SMOKE as ``repro.configs.vit_h14``.
"""

from repro_torch.configs.shapes import VISION_SHAPES
from repro_torch.models.vit import ViTConfig

FAMILY = "vision"
SHAPES = VISION_SHAPES

FULL = ViTConfig(
    name="vit-h14", img_res=224, patch=14, n_layers=32, d_model=1280,
    n_heads=16, d_ff=5120, pos_grid=16,
)

SMOKE = ViTConfig(
    name="vit-h-smoke", img_res=28, patch=7, n_layers=2, d_model=32,
    n_heads=4, d_ff=64, n_classes=10, pos_grid=4,
)
