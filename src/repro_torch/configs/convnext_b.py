"""convnext-b [arXiv:2201.03545; paper].

img_res=224 depths=(3,3,27,3) dims=(128,256,512,1024).  The same FULL and
SMOKE as ``repro.configs.convnext_b``.
PhoneBit technique: 1×1 MLP convs binarize (binary variant); 7×7 depthwise
stays float.
"""

from repro_torch.configs.shapes import VISION_SHAPES
from repro_torch.models.convnext import ConvNeXtConfig

FAMILY = "vision"
SHAPES = VISION_SHAPES

FULL = ConvNeXtConfig(
    name="convnext-b", img_res=224, depths=(3, 3, 27, 3),
    dims=(128, 256, 512, 1024),
)

SMOKE = ConvNeXtConfig(
    name="convnext-smoke", img_res=32, depths=(1, 1, 2, 1),
    dims=(16, 32, 64, 128), n_classes=10,
)
