"""K1: weighted xor-popcount count matmul (paper Eqn 1; Eqn 2's bit-plane
weights through ``word_weights``).

Port of ``repro.kernels.xnor_popcount_matmul.xnor_popcount_matmul``; the
CUDA kernel is ``csrc/xnor_popcount_matmul.cu``:

    cnt[m, n] = sum_w ww[w] * popcount(a[m, w] ^ b[n, w])

a (M, W), b (N, W) int32 packed rows, ww (W,) int32 or None (all ones)
-> (M, N) int32.  The reference's ``reduction="loop"`` is a benchmark
baseline there and is not ported.
"""

from __future__ import annotations

import torch

from repro_torch.core import binary_ops
from repro_torch.kernels import build


def xnor_popcount_matmul_plain(a, b, word_weights=None) -> torch.Tensor:
    """The plain PyTorch version: the chunked xor-popcount counts of
    ``core.binary_ops``."""
    return binary_ops.packed_matmul_counts(a, b, word_weights=word_weights)


def xnor_popcount_matmul(a: torch.Tensor, b: torch.Tensor,
                         word_weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(M, N) int32 weighted xor-popcount counts of packed rows.

    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version.
    """
    if a.device.type == "cpu":
        return xnor_popcount_matmul_plain(a, b, word_weights)
    if a.device.type != "cuda":
        raise ValueError(f"xnor_popcount_matmul: unsupported device "
                         f"{a.device}")
    dev = a.device
    build.require(a, "a", torch.int32, 2, dev)
    build.require(b, "b", torch.int32, 2, dev)
    m, w = a.shape
    n = b.shape[0]
    if b.shape[1] != w:
        raise ValueError(f"xnor_popcount_matmul: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree on the word axis")
    ww_ptr = None
    if word_weights is not None:
        build.require(word_weights, "word_weights", torch.int32, 1, dev)
        if word_weights.shape[0] != w:
            raise ValueError(f"word_weights has {word_weights.shape[0]} "
                             f"entries, want {w}")
        ww_ptr = word_weights.data_ptr()
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    lib = build.library()
    xnor_popcount_matmul.launches += 1
    build.check(lib.launch_xnor_popcount_matmul(
        a.data_ptr(), b.data_ptr(), ww_ptr, out.data_ptr(), m, n, w,
        build.stream_ptr(dev)), "xnor_popcount_matmul")
    return out


xnor_popcount_matmul.launches = 0
