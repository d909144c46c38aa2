"""K1: weighted xor-popcount count matmul (paper Eqn 1; Eqn 2's bit-plane
weights through ``word_weights``).

Port of ``repro.kernels.xnor_popcount_matmul.xnor_popcount_matmul``; the
CUDA kernel is ``csrc/xnor_popcount_matmul.cu``:

    cnt[m, n] = sum_w ww[w] * popcount(a[m, w] ^ b[n, w])

a (M, W), b (N, W) int32 packed rows, ww (W,) int32 or None (all ones)
-> (M, N) int32.  The reference's ``reduction="loop"`` is a benchmark
baseline there and is not ported.

Two wrappers, each with its own launch count:

* :func:`xnor_popcount_matmul` — any operands.  Without word weights it
  launches the int8 tensor-core kernel (+-1 bytes, ``cnt = (32·W -
  dot)/2``); with word weights, the CUDA-core kernel.
* :func:`xnor_popcount_matmul_planes` — the bit-plane first layer's im2col
  rows against its filters in the u8 x s8 form
  (``core.bitplanes.plane_filters``): the tensor-core kernel on plane
  bytes, ``cnt = const - dot``.

:func:`plan_gemm` picks the tensor-core kernel's tile and how many slices
the reduction is split into.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import binary_ops, bitplanes
from repro_torch.kernels import build

# Tensor-core tiles (rows, columns), in the launcher's numbering.
GEMM_TILES = ((64, 64), (64, 96), (16, 128))
SMS = 132
KC = 4                  # k32 steps a staging step


@functools.lru_cache(maxsize=None)
def plan_gemm(m: int, n: int, ks: int, sms: int = SMS) -> tuple[int, int]:
    """(tile, slices) of one tensor-core launch: 16 x 128 for up to 16
    rows (each filter word read once), else 64 x 96 where 96 columns
    waste less than 64, else 64 x 64; the reduction over ``ks`` k32 steps
    is split until the grid has two blocks an SM, keeping at least 8
    staging steps a slice.  Cached: a serving shape plans once."""
    if m <= 16:
        tile = 2
    else:
        waste = {t: math.ceil(n / GEMM_TILES[t][1]) * GEMM_TILES[t][1] - n
                 for t in (0, 1)}
        tile = 1 if waste[1] < waste[0] else 0
    bm, bn = GEMM_TILES[tile]
    blocks = math.ceil(m / bm) * math.ceil(n / bn)
    slices = max(1, min(math.ceil(2 * sms / blocks), ks // (8 * KC)))
    return tile, slices


def _launch_mma(a, b, const, ks: int, cw: int, planes: bool
                ) -> torch.Tensor:
    m, n = a.shape[0], b.shape[0]
    tile, slices = plan_gemm(m, n, ks, build.sm_count(a.device))
    out = (torch.zeros if slices > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=a.device)
    build.check(build.library().launch_xnor_popcount_mma(
        a.data_ptr(), b.data_ptr(),
        const.data_ptr() if const is not None else None, out.data_ptr(), m,
        n, ks, cw, tile, slices, int(planes), build.stream_ptr(a.device)),
        "xnor_popcount_matmul (mma)")
    return out


def xnor_popcount_matmul_plain(a, b, word_weights=None) -> torch.Tensor:
    """The plain PyTorch version: the chunked xor-popcount counts of
    ``core.binary_ops``."""
    return binary_ops.packed_matmul_counts(a, b, word_weights=word_weights)


def xnor_popcount_matmul(a: torch.Tensor, b: torch.Tensor,
                         word_weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """(M, N) int32 weighted xor-popcount counts of packed rows.

    Launches a CUDA kernel for CUDA tensors — the tensor-core kernel
    without word weights, the CUDA-core kernel with them; CPU tensors take
    the plain version.
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
    if word_weights is None:
        out = _launch_mma(a, b, None, w, 1, planes=False)
        xnor_popcount_matmul.launches += 1
        return out
    build.require(word_weights, "word_weights", torch.int32, 1, dev)
    if word_weights.shape[0] != w:
        raise ValueError(f"word_weights has {word_weights.shape[0]} "
                         f"entries, want {w}")
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    lib = build.library()
    xnor_popcount_matmul.launches += 1
    build.check(lib.launch_xnor_popcount_matmul(
        a.data_ptr(), b.data_ptr(), word_weights.data_ptr(), out.data_ptr(),
        m, n, w, build.stream_ptr(dev)), "xnor_popcount_matmul")
    return out


xnor_popcount_matmul.launches = 0


def xnor_popcount_matmul_planes_plain(a, filters: bitplanes.PlaneFilters,
                                      cw: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the bit-plane variant, by the u8 x s8
    identity: each k32 step's 8 plane words become 32 bytes
    (``bitplanes.plane_bytes``) and ``cnt = const - bytes · signs``."""
    m = a.shape[0]
    taps = filters.signs.shape[1] // cw
    u = bitplanes.plane_bytes(a.reshape(m, taps, -1)).reshape(m, -1)
    dot = bitplanes.byte_sign_dot(u, filters.signs)
    return (filters.const.to(torch.int64)[None] - dot).to(torch.int32)


def xnor_popcount_matmul_planes(a: torch.Tensor,
                                filters: bitplanes.PlaneFilters,
                                cw: int = 1) -> torch.Tensor:
    """(M, N) int32 counts of im2col rows ``a`` (M, taps·8·Cw) of plane
    words in (tap, plane, word) order against first-layer filters in the
    u8 x s8 form (``bitplanes.plane_filters``): the counts
    :func:`xnor_popcount_matmul` gives for the converter's filters and
    plane word weights, bit for bit.  ``cw``: words a plane.

    Launches the tensor-core kernel on plane bytes for CUDA tensors; CPU
    tensors take the plain version.
    """
    if a.device.type == "cpu":
        return xnor_popcount_matmul_planes_plain(a, filters, cw)
    if a.device.type != "cuda":
        raise ValueError(f"xnor_popcount_matmul_planes: unsupported device "
                         f"{a.device}")
    dev = a.device
    build.require(a, "a", torch.int32, 2, dev)
    build.require(filters.signs, "signs", torch.int32, 2, dev)
    build.require(filters.const, "const", torch.int32, 1, dev)
    n, ks = filters.signs.shape
    if a.shape[1] != bitplanes.NUM_PLANES * ks or ks % cw \
            or filters.const.shape[0] != n:
        raise ValueError(f"xnor_popcount_matmul_planes: a "
                         f"{tuple(a.shape)} is not 8 planes of signs "
                         f"{tuple(filters.signs.shape)} with {cw} words a "
                         f"plane")
    build.require(filters.bytes, "bytes", torch.int8, 2, dev)
    out = _launch_mma(a, filters.bytes, filters.const, ks, cw, planes=True)
    xnor_popcount_matmul_planes.launches += 1
    return out


xnor_popcount_matmul_planes.launches = 0
