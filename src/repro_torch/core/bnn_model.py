"""BNN network assembly: layer specs, a seeded init, and the packed oracle.

Counterpart of ``repro.core.bnn_model``.  A network is a sequence of layer
specs (Fig 3's conv/pool/dense calls).  :func:`packed_forward` is the flat
walk of the deployed integer path — the oracle behind the engine's
``legacy_call`` and ``cross_check``; :func:`float_forward` is the float
oracle of the trained params and, with ``train=True``, the training
forward, whose signs take the straight-through gradient
(``binarize.ste_sign``); :func:`to_graph` lowers trained params to the
unfused operator graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (binarize, binary_conv, binary_ops, bitplanes,
                              packing)

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


def float_conv_nhwc(x: torch.Tensor, w: torch.Tensor, b, stride: int,
                    pad: int) -> torch.Tensor:
    """NHWC x HWIO float conv (+ bias unless ``b`` is None), in full
    float32 (the reference's ``lax.conv_general_dilated`` layout)."""
    with binary_ops.full_float32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b


def _param(v, device) -> torch.Tensor:
    """A latent param (torch tensor or numpy array) as a tensor on
    ``device``."""
    t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    return t.to(device)


def bn_sigma(var: torch.Tensor) -> torch.Tensor:
    """The paper's sigma: sqrt(running_var + eps), in float32."""
    return torch.sqrt(var + _BN_EPS)


def bn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Inference BN in float32, the reference's operation order.  The
    unfused graph's ``bn_binarize`` and the folds of ``integrate_bn`` and
    the converter take it and :func:`bn_sigma` from here, so their bits
    agree."""
    return p["gamma"] * (x - p["mu"]) / bn_sigma(p["var"]) + p["beta"]


def sign(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, 1.0, -1.0).to(v.dtype)


def max_pool_nhwc(x: torch.Tensor, window: int, stride: int,
                  pad: tuple[int, int] = (0, 0), fill: float = -1.0
                  ) -> torch.Tensor:
    """Float max pool on NHWC; ``pad`` = (lo, hi) on both spatial dims
    with ``fill``."""
    lo, hi = pad
    if (lo, hi) != (0, 0):
        x = F.pad(x, (0, 0, lo, hi, lo, hi), value=fill)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def float_forward(params: Sequence[dict], spec: Sequence[LayerSpec],
                  x_uint8: torch.Tensor, *, train: bool = False
                  ) -> torch.Tensor:
    """The float oracle of the packed engine.  x_uint8: (N, H, W, C) uint8;
    returns the final float logits, on ``x_uint8``'s device.

    Binary convs pad with -1 (DESIGN.md §3.2), so every sign below equals
    the packed engine's bit; the first conv pads with 0 (a real 0 pixel).
    Convs and matmuls run in full float32: the sums of +-1 (and of uint8
    pixels times +-1) are then exact.  With ``train=True`` every sign is
    ``binarize.ste_sign``, so the net is differentiable in the latent
    float weights (the values are the same).
    """
    sign_fn = binarize.ste_sign if train else sign
    dev = x_uint8.device
    x = x_uint8.to(torch.float32)
    with binary_ops.full_float32():
        for layer, p in zip(spec, params):
            p = {k: _param(v, dev) for k, v in p.items()}
            if isinstance(layer, BConv):
                wb = sign_fn(p["w"])
                if not layer.first:
                    # +-1 activations, -1 padding == pad the map with -1.
                    x = F.pad(x, (0, 0) + (layer.pad,) * 4, value=-1.0)
                x = float_conv_nhwc(x, wb, None, layer.stride,
                                    layer.pad if layer.first else 0)
                x = sign_fn(bn(x, p))
            elif isinstance(layer, Pool):
                x = max_pool_nhwc(x, layer.window, layer.stride,
                                  tuple(layer.pad))
            elif isinstance(layer, BDense):
                x = x.reshape(x.shape[0], -1) @ sign_fn(p["w"])
                x = sign_fn(bn(x, p))
            elif isinstance(layer, FloatDense):
                x = x.reshape(x.shape[0], -1) @ p["w"] + p["b"]
            elif isinstance(layer, FloatConv):
                x = float_conv_nhwc(x, p["w"], p["b"], layer.stride,
                                    layer.pad)
    return x


def to_graph(params: Sequence[dict], spec: Sequence[LayerSpec],
             input_hw: tuple[int, int]):
    """Lower trained latent-float params to the *unfused* operator graph,
    the input of :func:`repro_torch.runtime.passes.default_pipeline`
    (imported here to avoid a core -> runtime cycle)."""
    from repro_torch.runtime.graph import lower_trained
    return lower_trained(spec, params, input_hw)


def packed_forward(packed: Sequence[dict], spec: Sequence[LayerSpec],
                   x_uint8: torch.Tensor, impl: str = "xor") -> torch.Tensor:
    """Deployed path on channel-packed int32 words (paper §V/§VI), as a flat
    walk over the spec with plain PyTorch ops.

    ``packed`` comes from :func:`repro_torch.core.converter.convert`; all
    hidden layers are integer ops, only the float head touches floats.
    ``impl`` picks the count form of the hidden layers ("xor" = Eqn 1,
    "pm1" = the +-1 matmul); the first layer's weighted words always take
    xor counts.
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
                layer.stride, layer.pad, word_weights=p.get("word_weights"),
                impl="xor" if layer.first else impl)
        elif isinstance(layer, Pool):
            x = binary_conv.binary_or_maxpool(x, layer.window, layer.stride,
                                              pad=tuple(layer.pad))
        elif isinstance(layer, BDense):
            x = binary_conv.binary_dense_fused(x.reshape(x.shape[0], -1),
                                               p["w_packed"], p["thresh"],
                                               impl=impl)
        elif isinstance(layer, FloatDense):
            # Unpack per position before flattening so per-word channel
            # padding never leaks into the float matmul.
            xv = packing.unpack_to_pm1(x, int(p["c_per_pos"]),
                                       dtype=torch.float32)
            with binary_ops.full_float32():
                x = xv.reshape(xv.shape[0], -1) @ p["w"] + p["b"]
        elif isinstance(layer, FloatConv):
            xv = packing.unpack_to_pm1(x, int(p["c_per_pos"]),
                                       dtype=torch.float32)
            x = float_conv_nhwc(xv, p["w"], p["b"], layer.stride, layer.pad)
    return x
