"""K2: integrated binary matmul + BN + binarize + 32-channel pack (C4+C6).

Port of ``repro.kernels.fused_conv_bn_binarize.fused_matmul_bn_binarize``;
the CUDA kernel is ``csrc/fused_conv_bn_binarize.cu``.  Operands are
matmul-shaped (dense inputs, or im2col patches under ``cuda_popcount``):

    cnt = sum_w ww[w] * popcount(a[m, w] ^ b[n, w]);  bit = (cnt <= t) ^ s

packed 32 output channels per int32 word, LSB-first; pad channels are 0.

Without word weights the kernel is the +-1 mainloop of
``csrc/pm1_gemm.cuh`` on the int8 tensor cores (``cnt = (32·W - dot) /
2``) with a threshold-and-pack epilogue, on the route
:func:`repro_torch.kernels.pm1_gemm.plan_pm1` picks: 64 x 64 ``wgmma``
tiles for many rows (the im2col convs under ``cuda_popcount``), or the
filters on ``mma.sync``'s 16-row side with the word axis split over a
thread-block cluster for few rows (fc6/fc7 at small batch), the leader
thresholding the whole count.  With word weights (the first layer's bit
planes under ``cuda_popcount``) it is the CUDA-core xor-popcount kernel,
exact for any weights.
"""

from __future__ import annotations

import torch

from repro_torch.core import binary_ops, layer_integration, packing
from repro_torch.kernels import build, pm1_gemm


def fused_matmul_bn_binarize_plain(a, b, threshold, sign_flip,
                                   word_weights=None) -> torch.Tensor:
    """The plain PyTorch version: chunked xor-popcount counts, threshold,
    pack."""
    cnt = binary_ops.packed_matmul_counts(a, b, word_weights=word_weights)
    bits = layer_integration.apply_threshold(
        cnt, layer_integration.IntegratedParams(threshold, sign_flip))
    return packing.pack_bits(bits, axis=-1)


def fused_matmul_bn_binarize(a: torch.Tensor, b: torch.Tensor,
                             threshold: torch.Tensor,
                             sign_flip: torch.Tensor,
                             word_weights: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """a: (M, W), b: (N, W) int32 packed rows; threshold (N,) int32;
    sign_flip (N,) bool; word_weights (W,) int32 or None (all ones)
    -> (M, ceil(N/32)) int32.

    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version.
    """
    if a.device.type == "cpu":
        return fused_matmul_bn_binarize_plain(a, b, threshold, sign_flip,
                                              word_weights)
    if a.device.type != "cuda":
        raise ValueError(f"fused_matmul_bn_binarize: unsupported device "
                         f"{a.device}")
    dev = a.device
    build.require(a, "a", torch.int32, 2, dev)
    build.require(b, "b", torch.int32, 2, dev)
    build.require(threshold, "threshold", torch.int32, 1, dev)
    build.require(sign_flip, "sign_flip", torch.bool, 1, dev)
    m, w = a.shape
    n = b.shape[0]
    if b.shape[1] != w or threshold.shape[0] != n or sign_flip.shape[0] != n:
        raise ValueError(f"fused_matmul_bn_binarize: shapes a {tuple(a.shape)}"
                         f" b {tuple(b.shape)} t {tuple(threshold.shape)} "
                         f"s {tuple(sign_flip.shape)} disagree")
    if word_weights is not None:
        build.require(word_weights, "word_weights", torch.int32, 1, dev)
        if word_weights.shape[0] != w:
            raise ValueError(f"word_weights has {word_weights.shape[0]} "
                             f"entries, want {w}")
    out = torch.empty((m, packing.num_words(n)), dtype=torch.int32,
                      device=dev)
    lib = build.library()
    fused_matmul_bn_binarize.launches += 1
    if word_weights is None:
        plan = pm1_gemm.plan_pm1(m, n, w, build.sm_count(dev))
        err = lib.launch_fused_matmul_bn_binarize_pm1(
            a.data_ptr(), b.data_ptr(), threshold.data_ptr(),
            sign_flip.data_ptr(), out.data_ptr(), m, n, w, plan.tile,
            plan.cluster, build.stream_ptr(dev))
    else:
        err = lib.launch_fused_matmul_bn_binarize(
            a.data_ptr(), b.data_ptr(), word_weights.data_ptr(),
            threshold.data_ptr(), sign_flip.data_ptr(), out.data_ptr(), m,
            n, w, build.stream_ptr(dev))
    build.check(err, "fused_matmul_bn_binarize")
    return out


fused_matmul_bn_binarize.launches = 0
