"""BNN network assembly: layer specs, a seeded init, and the packed oracle.

Counterpart of ``repro.core.bnn_model``.  A network is a sequence of layer
specs (Fig 3's conv/pool/dense calls).  :func:`packed_forward` is the flat
walk of the deployed integer path — the oracle behind the engine's
``legacy_call`` and ``cross_check``.  The float training forward is not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import binary_conv, bitplanes, packing

_BN_EPS = 1e-4


@dataclasses.dataclass(frozen=True)
class BConv:
    """Integrated binary conv + BN + binarize (first=True: bit-plane input)."""
    c_in: int
    c_out: int
    kernel: int = 3
    stride: int = 1
    pad: int = 1
    first: bool = False

    @property
    def k_valid(self) -> int:
        return self.kernel * self.kernel * self.c_in


@dataclasses.dataclass(frozen=True)
class Pool:
    """Max pool; pad = (lo, hi) on both spatial dims, 0-words on the packed
    path (YOLOv2-Tiny's stride-1 pool6 pads (0, 1) to keep 13x13)."""
    window: int = 2
    stride: int = 2
    pad: tuple[int, int] = (0, 0)


@dataclasses.dataclass(frozen=True)
class BDense:
    """Integrated binary dense + BN + binarize; input is flattened NHWC."""
    d_in: int
    d_out: int


@dataclasses.dataclass(frozen=True)
class FloatDense:
    """Paper's final full-precision layer."""
    d_in: int
    d_out: int


@dataclasses.dataclass(frozen=True)
class FloatConv:
    """Full-precision conv (YOLOv2-Tiny's conv9: 1x1, float in/out)."""
    c_in: int
    c_out: int
    kernel: int = 1
    stride: int = 1
    pad: int = 0


LayerSpec = Any  # BConv | Pool | BDense | FloatDense | FloatConv


def init_params(rng: np.random.Generator,
                spec: Sequence[LayerSpec]) -> list[dict]:
    """Latent float params (float32 CPU tensors) drawn from a numpy
    generator, with the reference's distributions: binary weights
    U(-1, 1), identity BN, float heads N(0, 1/fan_in).

    This does NOT reproduce the bits of the reference's ``jax.random``
    init: parity tests hand the same numpy params to both sides instead.
    """
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def bn(o):
        return dict(gamma=t(np.ones(o)), beta=t(np.zeros(o)),
                    mu=t(np.zeros(o)), var=t(np.ones(o)))

    params: list[dict] = []
    for layer in spec:
        if isinstance(layer, BConv):
            w = rng.uniform(-1.0, 1.0, (layer.kernel, layer.kernel,
                                        layer.c_in, layer.c_out))
            params.append(dict(w=t(w), **bn(layer.c_out)))
        elif isinstance(layer, BDense):
            w = rng.uniform(-1.0, 1.0, (layer.d_in, layer.d_out))
            params.append(dict(w=t(w), **bn(layer.d_out)))
        elif isinstance(layer, FloatDense):
            w = rng.standard_normal((layer.d_in, layer.d_out))
            params.append(dict(w=t(w / np.sqrt(layer.d_in)),
                               b=t(np.zeros(layer.d_out))))
        elif isinstance(layer, FloatConv):
            fan = layer.kernel * layer.kernel * layer.c_in
            w = rng.standard_normal((layer.kernel, layer.kernel,
                                     layer.c_in, layer.c_out))
            params.append(dict(w=t(w / np.sqrt(fan)),
                               b=t(np.zeros(layer.c_out))))
        else:
            params.append({})
    return params


def float_conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int, pad: int) -> torch.Tensor:
    """NHWC x HWIO float conv + bias (the reference's
    ``lax.conv_general_dilated`` layout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1) + b


def packed_forward(packed: Sequence[dict], spec: Sequence[LayerSpec],
                   x_uint8: torch.Tensor) -> torch.Tensor:
    """Deployed path on channel-packed int32 words (paper §V/§VI), as a flat
    walk over the spec with plain PyTorch ops (xor count form).

    ``packed`` comes from :func:`repro_torch.core.converter.convert`; all
    hidden layers are integer ops, only the float head touches floats.
    """
    x = None
    for layer, p in zip(spec, packed):
        if isinstance(layer, BConv):
            if layer.first:
                planes = bitplanes.pack_bitplanes(x_uint8)   # (N,H,W,8,Cw)
                n, h, w, np_, cw = planes.shape
                x = planes.reshape(n, h, w, np_ * cw)
            x = binary_conv.binary_conv2d_fused(
                x, p["w_packed"], p["thresh"], layer.kernel, layer.kernel,
                layer.stride, layer.pad, word_weights=p.get("word_weights"))
        elif isinstance(layer, Pool):
            x = binary_conv.binary_or_maxpool(x, layer.window, layer.stride,
                                              pad=tuple(layer.pad))
        elif isinstance(layer, BDense):
            x = binary_conv.binary_dense_fused(x.reshape(x.shape[0], -1),
                                               p["w_packed"], p["thresh"])
        elif isinstance(layer, FloatDense):
            # Unpack per position before flattening so per-word channel
            # padding never leaks into the float matmul.
            xv = packing.unpack_to_pm1(x, int(p["c_per_pos"]),
                                       dtype=torch.float32)
            x = xv.reshape(xv.shape[0], -1) @ p["w"] + p["b"]
        elif isinstance(layer, FloatConv):
            xv = packing.unpack_to_pm1(x, int(p["c_per_pos"]),
                                       dtype=torch.float32)
            x = float_conv_nhwc(xv, p["w"], p["b"], layer.stride, layer.pad)
    return x
