"""Packed binary convolution + pooling on the NHWC channel-packed layout.

Counterpart of ``repro.core.binary_conv``: im2col over packed words
(spatial patches gathered with strided slices, patch words ordered
(kh, kw, Cw) major-to-minor), then one count matmul in xor or pm1 form
(``impl``, :func:`repro_torch.core.binary_ops.packed_matmul_counts`).

Padding: spatial padding inserts 0-words, i.e. 32 channels of -1 (the
-1-padding convention of DESIGN.md §3.2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import binary_ops, layer_integration, packing


def conv_out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _strided_window(x: torch.Tensor, i: int, j: int, oh: int, ow: int,
                    stride: int) -> torch.Tensor:
    """x[:, i::stride, j::stride, :] cut to (oh, ow) — one tap's view."""
    return x[:, i:i + (oh - 1) * stride + 1:stride,
             j:j + (ow - 1) * stride + 1:stride, :]


def extract_patches_packed(x: torch.Tensor, kh: int, kw: int,
                           stride: int = 1, pad: int = 0) -> torch.Tensor:
    """im2col on packed input: (N, H, W, Cw) int32 ->
    (N, OH, OW, kh*kw*Cw) int32, patch words ordered (kh, kw, Cw)."""
    n, h, w, cw = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    return torch.cat([_strided_window(x, i, j, oh, ow, stride)
                      for i in range(kh) for j in range(kw)], dim=-1)


def im2col_matmul(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                  pad: int = 0) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """``(patches_2d, (n, oh, ow))`` with ``patches_2d`` the
    ``(n*oh*ow, kh*kw*Cw)`` matmul-shaped view of the packed patches."""
    patches = extract_patches_packed(x, kh, kw, stride, pad)
    n, oh, ow, pw = patches.shape
    return patches.reshape(n * oh * ow, pw), (n, oh, ow)


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """(KH, KW, C, O) +-1/float weights -> (O, KH*KW*Cw) packed filters,
    word order (kh, kw, word) as in :func:`extract_patches_packed`."""
    w = torch.as_tensor(w)
    kh, kw, c, o = w.shape
    packed = packing.pack_signs(w, axis=2)           # (KH, KW, Cw, O)
    packed = packed.permute(3, 0, 1, 2)              # (O, KH, KW, Cw)
    return packed.reshape(o, kh * kw * packed.shape[-1]).contiguous()


def binary_conv2d_counts(x_packed: torch.Tensor, w_packed: torch.Tensor,
                         kh: int, kw: int, stride: int = 1, pad: int = 0,
                         word_weights: torch.Tensor | None = None,
                         impl: str = "xor") -> torch.Tensor:
    """cnt[n,oh,ow,o] = sum_w ww[w] * popcount(patch ^ filter)."""
    flat, (n, oh, ow) = im2col_matmul(x_packed, kh, kw, stride, pad)
    cnt = binary_ops.packed_matmul_counts(flat, w_packed,
                                          word_weights=word_weights,
                                          impl=impl)
    return cnt.reshape(n, oh, ow, w_packed.shape[0])


def binary_conv2d_dot(x_packed: torch.Tensor, w_packed: torch.Tensor,
                      k_valid: int, kh: int, kw: int, stride: int = 1,
                      pad: int = 0) -> torch.Tensor:
    """+-1 dot products: K - 2*cnt (paper Eqn 1), int32 NHWO."""
    cnt = binary_conv2d_counts(x_packed, w_packed, kh, kw, stride, pad)
    return k_valid - 2 * cnt


def binary_conv2d_fused(x_packed: torch.Tensor, w_packed: torch.Tensor,
                        p: layer_integration.IntegratedParams,
                        kh: int, kw: int, stride: int = 1, pad: int = 0,
                        word_weights: torch.Tensor | None = None,
                        impl: str = "xor") -> torch.Tensor:
    """Integrated conv+BN+binarize with packed output (N, OH, OW, Ow)."""
    cnt = binary_conv2d_counts(x_packed, w_packed, kh, kw, stride, pad,
                               word_weights=word_weights, impl=impl)
    return packing.pack_bits(layer_integration.apply_threshold(cnt, p),
                             axis=-1)


def binary_or_maxpool(x_packed: torch.Tensor, window: int, stride: int,
                      pad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Max-pool on packed binary maps = bitwise OR over the window.

    ``pad`` = (lo, hi) pads both spatial dims with 0-words (32 channels of
    -1, the OR identity) before pooling.
    """
    lo, hi = pad
    if (lo, hi) != (0, 0):
        x_packed = F.pad(x_packed, (0, 0, lo, hi, lo, hi))
    n, h, w, cw = x_packed.shape
    oh = (h - window) // stride + 1
    ow = (w - window) // stride + 1
    out = None
    for i in range(window):
        for j in range(window):
            s = _strided_window(x_packed, i, j, oh, ow, stride)
            out = s if out is None else (out | s)
    return out.contiguous()


def binary_dense_fused(x_packed: torch.Tensor, w_packed: torch.Tensor,
                       p: layer_integration.IntegratedParams,
                       impl: str = "xor") -> torch.Tensor:
    """Integrated dense+BN+binarize with packed output (..., Ow)."""
    cnt = binary_ops.binary_dense_counts(x_packed, w_packed, impl=impl)
    return packing.pack_bits(layer_integration.apply_threshold(cnt, p),
                             axis=-1)


def final_float_dense(x_packed: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None, channels: int) -> torch.Tensor:
    """Paper's final full-precision layer: unpack +-1 acts, float32 matmul
    (in full float32)."""
    xv = packing.unpack_to_pm1(x_packed, channels, dtype=torch.float32)
    with binary_ops.full_float32():
        out = xv @ w.to(torch.float32)
    if b is not None:
        out = out + b.to(torch.float32)
    return out
