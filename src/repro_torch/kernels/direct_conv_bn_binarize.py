"""K3: direct (im2col-free) fused binary conv + BN + binarize + pack, with
an optional OR-pool epilogue (DESIGN.md §5).

Port of ``repro.kernels.direct_conv_bn_binarize.direct_conv_bn_binarize``;
the CUDA kernel is ``csrc/direct_conv_bn_binarize.cu``.  Neither im2col
patches nor unpacked counts (nor, with the pool, the pre-pool conv map)
are written to device memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import (binary_conv, binary_ops, layer_integration,
                              packing)
from repro_torch.kernels import build


def _geometry(h, w, kh, kw, stride, pad, pool):
    oh = binary_conv.conv_out_size(h, kh, stride, pad)
    ow = binary_conv.conv_out_size(w, kw, stride, pad)
    if pool is None:
        return oh, ow, oh, ow
    window, pstride, (lo, hi) = pool
    return (oh, ow, (oh + lo + hi - window) // pstride + 1,
            (ow + lo + hi - window) // pstride + 1)


def direct_conv_bn_binarize_plain(x, w_packed, threshold, sign_flip, *,
                                  kh: int, kw: int, stride: int = 1,
                                  pad: int = 0, word_weights=None,
                                  pool=None) -> torch.Tensor:
    """The plain PyTorch version, by the direct algorithm: counts
    accumulate over KH*KW shifted, strided taps of the zero-word-padded
    input (no patch tensor), then threshold + pack, then the OR-pool over
    0-word pool padding — the kernel's padding and pool geometry."""
    n, h, w_in, cw = x.shape
    o = w_packed.shape[0]
    oh, ow, _, _ = _geometry(h, w_in, kh, kw, stride, pad, pool)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    cnt = torch.zeros((n * oh * ow, o), dtype=torch.int32, device=x.device)
    for di in range(kh):
        for dj in range(kw):
            k0 = (di * kw + dj) * cw
            tap = xp[:, di:di + (oh - 1) * stride + 1:stride,
                     dj:dj + (ow - 1) * stride + 1:stride, :]
            cnt += binary_ops.packed_matmul_counts(
                tap.reshape(-1, cw), w_packed[:, k0:k0 + cw],
                None if word_weights is None else word_weights[k0:k0 + cw])
    bits = layer_integration.apply_threshold(
        cnt, layer_integration.IntegratedParams(threshold, sign_flip))
    out = packing.pack_bits(bits, axis=-1).reshape(n, oh, ow, -1)
    if pool is not None:
        out = binary_conv.binary_or_maxpool(out, pool[0], pool[1],
                                            pad=tuple(pool[2]))
    return out


def direct_conv_bn_binarize(x: torch.Tensor, w_packed: torch.Tensor,
                            threshold: torch.Tensor, sign_flip: torch.Tensor,
                            *, kh: int, kw: int, stride: int = 1,
                            pad: int = 0,
                            word_weights: torch.Tensor | None = None,
                            pool: tuple[int, int, tuple[int, int]] | None
                            = None) -> torch.Tensor:
    """Direct fused conv(+pool): packed NHWC in, packed NHWC out.

    x: (N, H, W, Cw) int32 (for the bit-plane first layer, Cw is the
    flattened 8*Cw plane-word dim); w_packed: (O, KH*KW*Cw) int32 in
    ``pack_conv_weights`` order; threshold (O,) int32; sign_flip (O,) bool;
    word_weights (KH*KW*Cw,) int32 or None (all ones); pool: optional
    ``(window, stride, (pad_lo, pad_hi))``.  Returns
    (N, OH', OW', ceil(O/32)) int32, pooled dims when ``pool`` is given.

    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version.
    """
    if x.device.type == "cpu":
        return direct_conv_bn_binarize_plain(
            x, w_packed, threshold, sign_flip, kh=kh, kw=kw, stride=stride,
            pad=pad, word_weights=word_weights, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"direct_conv_bn_binarize: unsupported device "
                         f"{x.device}")
    dev = x.device
    build.require(x, "x", torch.int32, 4, dev)
    build.require(w_packed, "w_packed", torch.int32, 2, dev)
    build.require(threshold, "threshold", torch.int32, 1, dev)
    build.require(sign_flip, "sign_flip", torch.bool, 1, dev)
    n, h, w_in, cw = x.shape
    o, k = w_packed.shape
    if k != kh * kw * cw or threshold.shape[0] != o \
            or sign_flip.shape[0] != o:
        raise ValueError(f"direct_conv_bn_binarize: w_packed "
                         f"{tuple(w_packed.shape)} / threshold / sign_flip "
                         f"disagree with x {tuple(x.shape)} and {kh}x{kw}")
    ww_ptr = None
    if word_weights is not None:
        build.require(word_weights, "word_weights", torch.int32, 1, dev)
        if word_weights.shape[0] != k:
            raise ValueError(f"word_weights has {word_weights.shape[0]} "
                             f"entries, want {k}")
        ww_ptr = word_weights.data_ptr()
    oh, ow, fh, fw = _geometry(h, w_in, kh, kw, stride, pad, pool)
    window, pstride, lo = ((1, 1, 0) if pool is None
                           else (pool[0], pool[1], pool[2][0]))
    out = torch.empty((n, fh, fw, packing.num_words(o)), dtype=torch.int32,
                      device=dev)
    lib = build.library()
    direct_conv_bn_binarize.launches += 1
    build.check(lib.launch_direct_conv_bn_binarize(
        x.data_ptr(), w_packed.data_ptr(), ww_ptr, threshold.data_ptr(),
        sign_flip.data_ptr(), out.data_ptr(), n, h, w_in, cw, o, kh, kw,
        stride, pad, oh, ow, window, pstride, lo, fh, fw,
        build.stream_ptr(dev)), "direct_conv_bn_binarize")
    return out


direct_conv_bn_binarize.launches = 0
