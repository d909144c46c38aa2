"""K6: +-1 dot products of packed words on the tensor cores.

Port of ``repro.kernels.mxu_pm1_matmul.mxu_pm1_matmul``; the CUDA kernel is
``csrc/mxu_pm1_matmul.cu``, the +-1 mainloop of ``csrc/pm1_gemm.cuh``
(packed words staged by ``cp.async``, int8 tensor-core products with
int32 accumulation) with the epilogue below:

    dot[m, n] = sum over all 32·W bits of pm1(a[m]) * pm1(b[n])
                - (32·W - k_valid)

for a (M, W), b (N, W) int32 packed rows -> (M, N) int32.  Pad bits agree
in both operands and add +1 each, so the correction is on the padded width
of the tensors.  The reference accumulates in float32 and is exact for
``k_valid <= 2^24``; both versions here are exact at every width.

Two routes, chosen by :func:`repro_torch.kernels.pm1_gemm.plan_pm1`: many
rows (the im2col convs) take 64 x 64 tiles of one warpgroup on ``wgmma``
(the filters' +-1 bytes in shared memory), split over a cluster as below
where the grid would leave SMs idle; few rows (fc6/fc7 at small
batch) put the filters on ``mma.sync``'s 16-row side and split the word
axis over a thread-block cluster, whose leader sums the partial dots
through distributed shared memory.
"""

from __future__ import annotations

import torch

from repro_torch.core import binary_ops, packing
from repro_torch.kernels import build, pm1_gemm


def mxu_pm1_matmul_plain(a, b, k_valid: int) -> torch.Tensor:
    """The plain PyTorch version: +-1 unpack and float32 matmuls over
    slabs whose sums are exact, added in int32
    (``core.binary_ops.pm1_dot``), then the pad correction."""
    return binary_ops.pm1_dot(a, b) - (a.shape[1] * packing.WORD_BITS
                                       - k_valid)


def mxu_pm1_matmul(a: torch.Tensor, b: torch.Tensor,
                   k_valid: int) -> torch.Tensor:
    """(M, N) int32 +-1 dots of packed rows over ``k_valid`` real bits.

    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version.
    """
    if a.device.type == "cpu":
        return mxu_pm1_matmul_plain(a, b, k_valid)
    if a.device.type != "cuda":
        raise ValueError(f"mxu_pm1_matmul: unsupported device {a.device}")
    dev = a.device
    build.require(a, "a", torch.int32, 2, dev)
    build.require(b, "b", torch.int32, 2, dev)
    m, w = a.shape
    n = b.shape[0]
    if b.shape[1] != w:
        raise ValueError(f"mxu_pm1_matmul: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree on the word axis")
    pad_bits = w * packing.WORD_BITS - k_valid
    if not 0 <= pad_bits < w * packing.WORD_BITS or w >= 1 << 26:
        raise ValueError(f"mxu_pm1_matmul: k_valid {k_valid} outside "
                         f"(0, {w * packing.WORD_BITS}] or W {w} too wide")
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    plan = pm1_gemm.plan_pm1(m, n, w, build.sm_count(dev))
    lib = build.library()
    mxu_pm1_matmul.launches += 1
    build.check(lib.launch_mxu_pm1_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, w, pad_bits,
        plan.tile, plan.cluster, build.stream_ptr(dev)),
        "mxu_pm1_matmul")
    return out


mxu_pm1_matmul.launches = 0
