"""Offline model transform (paper Fig 2): trained params -> packed engine.

Counterpart of ``repro.core.converter``.  Given latent float params (torch
tensors or numpy arrays, e.g. the JAX package's params handed over as
numpy), :func:`convert` yields the packed artifact — bit-packed weights,
BN folded into integer thresholds, first-layer bit-plane word weights, the
float head kept in float — with ``w_packed``, ``word_weights``,
``threshold`` and ``sign_flip`` bit-identical to the reference's.

:func:`save_artifact` / :func:`load_artifact` use the reference's ``.npz``
key format (``"{layer}.{name}"``, and ``"{layer}.thresh.threshold"`` /
``"{layer}.thresh.sign_flip"`` for the folded params), so either package
reads the other's files.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import bitplanes, binary_conv, layer_integration, packing
from repro_torch.core.bnn_model import (BConv, BDense, FloatConv, FloatDense,
                                        LayerSpec, Pool, bn_sigma)


def _t(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.require(np.asarray(x), requirements="W"))


def _sigma(var) -> torch.Tensor:
    return bn_sigma(_t(var).to(torch.float32))


def _bn(p: dict) -> tuple:
    return (p["gamma"], p["beta"], p["mu"], _sigma(p["var"]))


def convert(params: Sequence[dict], spec: Sequence[LayerSpec],
            input_hw: tuple[int, int]) -> list[dict]:
    """Fold + pack trained float params into the deployable packed list."""
    packed: list[dict] = []
    h, w = input_hw
    c = None        # current channel count; None until the first conv
    flat_d = None   # set once the activation is flattened (after BDense)

    for layer, p in zip(spec, params):
        p = {k: _t(v) for k, v in p.items()}
        if isinstance(layer, BConv):
            if layer.first:
                cw = packing.num_words(layer.c_in)
                wp = packing.pack_signs(p["w"], axis=2)          # KH,KW,Cw,O
                wp = wp[:, :, None].expand(-1, -1, bitplanes.NUM_PLANES,
                                           -1, -1)               # KH,KW,8,Cw,O
                wp = wp.permute(4, 0, 1, 2, 3).reshape(layer.c_out, -1)
                word_weights = bitplanes.plane_word_weights(cw).repeat(
                    layer.kernel * layer.kernel)
                wb = torch.where(p["w"] >= 0, 1.0, -1.0).to(torch.float32)
                w_sum = wb.sum(dim=(0, 1, 2))                    # (O,)
                thresh = layer_integration.fold_bn_first_layer(
                    layer.k_valid, w_sum, *_bn(p), bias=p.get("b", 0.0))
                packed.append(dict(w_packed=wp.contiguous(),
                                   word_weights=word_weights,
                                   thresh=thresh))
            else:
                thresh = layer_integration.fold_bn(
                    layer.k_valid, *_bn(p), bias=p.get("b", 0.0))
                packed.append(dict(
                    w_packed=binary_conv.pack_conv_weights(p["w"]),
                    thresh=thresh))
            h = binary_conv.conv_out_size(h, layer.kernel, layer.stride,
                                          layer.pad)
            w = binary_conv.conv_out_size(w, layer.kernel, layer.stride,
                                          layer.pad)
            c = layer.c_out
        elif isinstance(layer, Pool):
            h = (h + sum(layer.pad) - layer.window) // layer.stride + 1
            w = (w + sum(layer.pad) - layer.window) // layer.stride + 1
            packed.append({})
        elif isinstance(layer, BDense):
            if flat_d is None:
                # Flattening a spatial map: pack per position to match the
                # engine's flatten of (N, H, W, Cw) words.
                if h * w * c != layer.d_in:
                    raise ValueError(
                        f"BDense d_in={layer.d_in} != {h}x{w}x{c}")
                w4 = p["w"].reshape(h, w, c, layer.d_out)
                wp = binary_conv.pack_conv_weights(w4)           # O, H*W*Cw
            else:
                if flat_d != layer.d_in:
                    raise ValueError(f"BDense d_in={layer.d_in} != {flat_d}")
                wp = packing.pack_signs(p["w"], axis=0).T.contiguous()
            thresh = layer_integration.fold_bn(
                layer.d_in, *_bn(p), bias=p.get("b", 0.0))
            packed.append(dict(w_packed=wp, thresh=thresh))
            flat_d = layer.d_out
            c = layer.d_out
        elif isinstance(layer, FloatDense):
            if flat_d is None and h * w * c != layer.d_in:
                raise ValueError(f"FloatDense d_in={layer.d_in} != "
                                 f"{h}x{w}x{c}")
            packed.append(dict(w=p["w"].to(torch.float32),
                               b=p["b"].to(torch.float32),
                               c_per_pos=flat_d if flat_d is not None
                               else c))
        elif isinstance(layer, FloatConv):
            if c != layer.c_in:
                raise ValueError(f"FloatConv c_in={layer.c_in} != {c}")
            packed.append(dict(w=p["w"].to(torch.float32),
                               b=p["b"].to(torch.float32), c_per_pos=c))
            h = binary_conv.conv_out_size(h, layer.kernel, layer.stride,
                                          layer.pad)
            w = binary_conv.conv_out_size(w, layer.kernel, layer.stride,
                                          layer.pad)
            c = layer.c_out
        else:
            packed.append({})
    return packed


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save_artifact(path: str, packed: Sequence[dict]) -> None:
    flat: dict[str, np.ndarray] = {}
    for i, layer in enumerate(packed):
        for k, v in layer.items():
            if isinstance(v, layer_integration.IntegratedParams):
                flat[f"{i}.{k}.threshold"] = _np(v.threshold)
                flat[f"{i}.{k}.sign_flip"] = _np(v.sign_flip)
            else:
                flat[f"{i}.{k}"] = _np(v)
    np.savez_compressed(path, **flat)


def load_artifact(path: str) -> list[dict]:
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    n_layers = 1 + max(int(k.split(".")[0]) for k in arrays)
    packed: list[dict] = [dict() for _ in range(n_layers)]
    pending: dict[tuple[int, str], dict] = {}
    for k, v in arrays.items():
        parts = k.split(".")
        i = int(parts[0])
        if len(parts) == 3:  # IntegratedParams field
            pending.setdefault((i, parts[1]), {})[parts[2]] = \
                torch.from_numpy(v)
        else:
            packed[i][parts[1]] = torch.from_numpy(v)
    for (i, name), fields in pending.items():
        packed[i][name] = layer_integration.IntegratedParams(
            fields["threshold"], fields["sign_flip"])
    return packed


def model_bytes(packed: Sequence[dict]) -> int:
    """Size of the deployable packed model (Tab II 'BNN' column)."""
    total = 0
    for layer in packed:
        for k, v in layer.items():
            if isinstance(v, layer_integration.IntegratedParams):
                total += v.threshold.numel() * 4 + v.sign_flip.numel()
            elif k not in ("word_weights", "c_per_pos"):
                a = _np(v)
                total += a.size * a.dtype.itemsize
    return total


def float_model_bytes(params: Sequence[dict]) -> int:
    """Size of the full-precision counterpart (Tab II 'CNN' column, fp32)."""
    return sum(_np(v).size * 4 for layer in params for v in layer.values())
