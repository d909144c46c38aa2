"""The paper's own workloads: AlexNet, VGG16, YOLOv2-Tiny (Tab II-IV, Fig 5).

Counterpart of ``repro.models.paper_nets``: the three network specs at
their published shapes (AlexNet/VGG16 at 1000-class ImageNet, YOLOv2-Tiny
at 416² VOC with 125 = 5·(20+5) output channels), and the float CNN
baseline the paper compares against (:func:`cnn_float_forward`).
"""

from __future__ import annotations

import torch

from repro_torch.core import binary_ops
from repro_torch.core.bnn_model import (BConv, BDense, FloatConv, FloatDense,
                                        Pool, _param, bn, float_conv_nhwc,
                                        max_pool_nhwc)


def alexnet_spec() -> list:
    """AlexNet, 227x227x3 input, 1000 classes.  conv1 = bit-plane layer."""
    return [
        BConv(3, 96, kernel=11, stride=4, pad=0, first=True),
        Pool(3, 2),
        BConv(96, 256, kernel=5, stride=1, pad=2),
        Pool(3, 2),
        BConv(256, 384, kernel=3, stride=1, pad=1),
        BConv(384, 384, kernel=3, stride=1, pad=1),
        BConv(384, 256, kernel=3, stride=1, pad=1),
        Pool(3, 2),
        BDense(6 * 6 * 256, 4096),
        BDense(4096, 4096),
        FloatDense(4096, 1000),
    ]


def vgg16_spec() -> list:
    """VGG16, 224x224x3 input, 1000 classes."""
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    spec: list = []
    c_in, first = 3, True
    for item in cfg:
        if item == "M":
            spec.append(Pool(2, 2))
        else:
            spec.append(BConv(c_in, item, kernel=3, stride=1, pad=1,
                              first=first))
            c_in, first = item, False
    spec += [BDense(7 * 7 * 512, 4096), BDense(4096, 4096),
             FloatDense(4096, 1000)]
    return spec


def yolov2_tiny_spec() -> list:
    """YOLOv2-Tiny, 416x416x3 input, 125 output channels (VOC: 5·(20+5)).

    conv9 is the paper's full-precision 1x1 head (Fig 5); pool6 is the
    darknet stride-1 'same' pool (pad (0,1)) keeping the 13x13 grid.
    """
    return [
        BConv(3, 16, kernel=3, stride=1, pad=1, first=True),
        Pool(2, 2),
        BConv(16, 32, kernel=3, stride=1, pad=1), Pool(2, 2),
        BConv(32, 64, kernel=3, stride=1, pad=1), Pool(2, 2),
        BConv(64, 128, kernel=3, stride=1, pad=1), Pool(2, 2),
        BConv(128, 256, kernel=3, stride=1, pad=1), Pool(2, 2),
        BConv(256, 512, kernel=3, stride=1, pad=1),
        Pool(2, 1, pad=(0, 1)),
        BConv(512, 1024, kernel=3, stride=1, pad=1),
        BConv(1024, 1024, kernel=3, stride=1, pad=1),
        FloatConv(1024, 125, kernel=1, stride=1, pad=0),
    ]


NETWORKS = {
    "alexnet": (alexnet_spec, (227, 227, 3)),
    "vgg16": (vgg16_spec, (224, 224, 3)),
    "yolov2-tiny": (yolov2_tiny_spec, (416, 416, 3)),
}


def get(name: str):
    """Returns (spec, input_hwc)."""
    fn, shape = NETWORKS[name]
    return fn(), shape


# --------------------------------------------------------------------------
# Full-precision CNN baseline (Tab III float frameworks)
# --------------------------------------------------------------------------

def cnn_float_forward(params, spec, x_uint8: torch.Tensor) -> torch.Tensor:
    """The float CNN the paper benchmarks against: same topology, ReLU+BN,
    full-precision weights (the latent floats), standard 0-padding; in
    full float32, on ``x_uint8``'s device."""
    dev = x_uint8.device
    x = x_uint8.to(torch.float32) / 255.0
    with binary_ops.full_float32():
        for layer, p in zip(spec, params):
            p = {k: _param(v, dev) for k, v in p.items()}
            if isinstance(layer, BConv):
                x = float_conv_nhwc(x, p["w"], None, layer.stride, layer.pad)
                x = torch.relu(bn(x, p))
            elif isinstance(layer, Pool):
                x = max_pool_nhwc(x, layer.window, layer.stride,
                                  tuple(layer.pad), fill=float("-inf"))
            elif isinstance(layer, BDense):
                x = torch.relu(bn(x.reshape(x.shape[0], -1) @ p["w"], p))
            elif isinstance(layer, FloatDense):
                x = x.reshape(x.shape[0], -1) @ p["w"] + p["b"]
            elif isinstance(layer, FloatConv):
                x = float_conv_nhwc(x, p["w"], p["b"], layer.stride,
                                    layer.pad)
    return x
