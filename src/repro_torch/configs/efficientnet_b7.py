"""efficientnet-b7 [arXiv:1905.11946; paper].

width_mult=2.0 depth_mult=3.1 (native img_res 600; the assigned shape set
runs 224/384).  The same FULL and SMOKE as
``repro.configs.efficientnet_b7``.
PhoneBit technique: 1×1 expand/project convs binarize (binary variant).
"""

from repro_torch.configs.shapes import VISION_SHAPES
from repro_torch.models.efficientnet import EffNetConfig

FAMILY = "vision"
SHAPES = VISION_SHAPES

FULL = EffNetConfig(
    name="efficientnet-b7", img_res=600, width=2.0, depth=3.1,
)

SMOKE = EffNetConfig(
    name="efficientnet-smoke", img_res=32, width=0.5, depth=0.4,
    n_classes=10,
)
