"""Execution-path dispatch for the PhoneBit kernels.

Counterpart of ``repro.kernels.ops``: the single conv/dense dispatch
surface the graph executor comes through.  Port backends and the JAX
modes they pair with in conformance tests:

====================  =====================  ===============================
port backend          JAX mode               behaviour
====================  =====================  ===============================
``torch``             ``xla``                plain PyTorch (im2col + counts)
``torch_pm1``         ``xla_pm1``            plain PyTorch, +-1 matmul form
``cuda_pm1``          ``mxu_pm1``            im2col + K6 (+-1 dots on the
                                             tensor cores, ``pm1_gemm``'s
                                             mainloop); K1 counts where
                                             words carry weights
``cuda_popcount``     ``vpu_popcount``       im2col + K2 (fused matmul:
                                             ``pm1_gemm``'s mainloop with a
                                             threshold-and-pack epilogue;
                                             its CUDA-core kernel where
                                             words carry weights)
``cuda_direct``       ``vpu_direct``         K3 (direct conv)
``cuda_direct_pool``  ``vpu_direct_pool``    K3 with the OR-pool epilogue
``cuda_chain``        ``vpu_chain``          K5 per fused region (an engine
                                             mode, not a per-node backend)
====================  =====================  ===============================

A ``cuda_*`` backend launches its kernel for a CUDA tensor and runs the
kernel's plain version for a CPU tensor; nothing falls back from one to
the other.

The pm1 forms have no +-1 counterpart for weighted words (the first
layer's bit planes, Eqn 2): there ``torch_pm1`` keeps xor counts, as the
reference's pm1 form does, and ``cuda_pm1`` takes K1's counts.

``planes=`` (a ``core.bitplanes.PlaneFilters``, which an executor builds
once for a first-layer node) sends ``cuda_direct`` to K3's and
``cuda_pm1`` / :func:`matmul_counts` to K1's bit-plane variant: the same
counts as a u8 x s8 product on the tensor cores.

Unweighted counts from the +-1 dot: ``cnt = (32·W - dot) / 2`` over all
``32·W`` bits of the operands (pad bits agree, add +1 to the dot each and
nothing to the count).  K6 and K2 take their tile and cluster split from
:func:`repro_torch.kernels.pm1_gemm.plan_pm1`: the im2col convs on
``wgmma`` tiles, the word axis split over a thread-block cluster only
where the grid leaves SMs idle; the dense layers at small batch on
``mma.sync`` with the filters on its 16-row side, split over a cluster.
"""

from __future__ import annotations

import torch

from repro_torch.core import (binary_conv, binary_ops, bitplanes,
                              layer_integration, packing)
from repro_torch.kernels import chain_conv as _chain
from repro_torch.kernels.bitplane_pack import bitplane_pack  # noqa: F401
from repro_torch.kernels.direct_conv_bn_binarize import (
    direct_conv_bn_binarize, direct_conv_bn_binarize_planes)
from repro_torch.kernels.fused_conv_bn_binarize import (
    fused_matmul_bn_binarize as _fused_kernel, fused_matmul_bn_binarize_plain)
from repro_torch.kernels.mxu_pm1_matmul import mxu_pm1_matmul
from repro_torch.kernels.xnor_popcount_matmul import (
    xnor_popcount_matmul, xnor_popcount_matmul_planes)

#: Port backend name -> the reference's matching mode.
JAX_MODE = {"torch": "xla", "torch_pm1": "xla_pm1", "cuda_pm1": "mxu_pm1",
            "cuda_popcount": "vpu_popcount", "cuda_direct": "vpu_direct",
            "cuda_direct_pool": "vpu_direct_pool", "cuda_chain": "vpu_chain"}
CONV_MODES = ("torch", "torch_pm1", "cuda_pm1", "cuda_popcount",
              "cuda_direct")
#: Modes of :func:`binary_matmul_dot` and of :func:`matmul_counts`.
DOT_MODES = ("cuda_popcount", "cuda_pm1", "torch")
COUNT_MODES = ("cuda_popcount", "torch")


def binary_matmul_dot(a: torch.Tensor, b: torch.Tensor, k_valid: int,
                      mode: str = "cuda_popcount") -> torch.Tensor:
    """Binary +-1 dots (M, N) int32 over ``k_valid`` real bits: K1
    (``k_valid - 2·cnt``), K6, or plain PyTorch."""
    if mode == "cuda_popcount":
        return k_valid - 2 * xnor_popcount_matmul(a, b)
    if mode == "cuda_pm1":
        return mxu_pm1_matmul(a, b, k_valid)
    if mode == "torch":
        return binary_ops.packed_matmul_dot(a, b, k_valid)
    raise ValueError(f"unknown matmul mode {mode!r}; want one of "
                     f"{DOT_MODES}")


def matmul_counts(a: torch.Tensor, b: torch.Tensor,
                  word_weights: torch.Tensor | None = None,
                  mode: str = "cuda_popcount", planes=None,
                  cw: int = 1) -> torch.Tensor:
    """Weighted xor-popcount counts (M, N) int32: K1 or plain PyTorch;
    with ``planes`` (``cw`` words a plane), K1's bit-plane variant."""
    if mode == "cuda_popcount":
        if planes is not None:
            return xnor_popcount_matmul_planes(a, planes, cw)
        return xnor_popcount_matmul(a, b, word_weights)
    if mode == "torch":
        return binary_ops.packed_matmul_counts(a, b, word_weights=word_weights)
    raise ValueError(f"counts not supported for mode {mode!r}; want one of "
                     f"{COUNT_MODES}")


def _pm1_counts(a: torch.Tensor, b: torch.Tensor, word_weights,
                planes=None, cw: int = 1) -> torch.Tensor:
    """``cuda_pm1`` counts: K6's +-1 dot over all 32·W bits, halved back to
    counts; the first layer's u8 x s8 filters (``planes``, ``cw`` words a
    plane) take K1's bit-plane variant, other weighted words K1."""
    if planes is not None:
        return xnor_popcount_matmul_planes(a, planes, cw)
    if word_weights is not None:
        return xnor_popcount_matmul(a, b, word_weights)
    total = a.shape[1] * packing.WORD_BITS
    return (total - mxu_pm1_matmul(a, b, total)) // 2


def fused_matmul_bn_binarize(a, b, p: layer_integration.IntegratedParams,
                             word_weights=None,
                             mode: str = "cuda_popcount", planes=None,
                             cw: int = 1) -> torch.Tensor:
    """Integrated matmul+BN+sign+pack: (M, ceil(N/32)) int32.  ``planes``
    (``cw`` words a plane) is taken by ``cuda_pm1`` only."""
    if mode == "cuda_popcount":
        return _fused_kernel(a, b, p.threshold, p.sign_flip, word_weights)
    if mode == "torch":
        return fused_matmul_bn_binarize_plain(a, b, p.threshold, p.sign_flip,
                                              word_weights)
    if mode == "cuda_pm1":
        cnt = _pm1_counts(a, b, word_weights, planes, cw)
    elif mode == "torch_pm1":
        cnt = binary_ops.packed_matmul_counts(a, b, word_weights=word_weights,
                                              impl="pm1")
    else:
        raise ValueError(f"fused path not supported for mode {mode!r}")
    return packing.pack_bits(layer_integration.apply_threshold(cnt, p),
                             axis=-1)


def fused_binary_dense(x_packed, w_packed,
                       p: layer_integration.IntegratedParams,
                       mode: str = "cuda_popcount") -> torch.Tensor:
    """Integrated dense+BN+binarize on flattened packed input."""
    flat = x_packed.reshape(x_packed.shape[0], -1)
    return fused_matmul_bn_binarize(flat, w_packed, p, mode=mode)


def fused_binary_conv2d(x_packed: torch.Tensor, w_packed: torch.Tensor,
                        p: layer_integration.IntegratedParams,
                        kh: int, kw: int, stride: int = 1, pad: int = 0,
                        word_weights=None, mode: str = "cuda_direct",
                        pool: tuple[int, int, tuple[int, int]] | None = None,
                        planes=None, tile: tuple[int, int, int] | None = None
                        ) -> torch.Tensor:
    """Fused conv+BN+binarize(+OR-pool) dispatch — one call site for every
    backend.  ``pool`` = ``(window, stride, (pad_lo, pad_hi))``: on
    ``cuda_direct`` it rides the kernel's epilogue, on the im2col backends
    it runs as a separate packed-domain OR-pool after the conv.
    ``planes``: the first layer's u8 x s8 filters, taken by ``cuda_direct``
    and ``cuda_pm1`` (the other modes keep the weighted words).  ``tile``:
    K3's ``(tile_h, tile_w, nw_block)`` in place of ``plan_mma``'s pick,
    ``cuda_direct`` only."""
    if tile is not None and mode != "cuda_direct":
        raise ValueError(f"mode {mode!r} takes no tile")
    if mode == "cuda_direct":
        if planes is not None:
            return direct_conv_bn_binarize_planes(
                x_packed, planes, p.threshold, p.sign_flip, kh=kh, kw=kw,
                stride=stride, pad=pad, pool=pool, tile=tile)
        return direct_conv_bn_binarize(
            x_packed, w_packed, p.threshold, p.sign_flip, kh=kh, kw=kw,
            stride=stride, pad=pad, word_weights=word_weights, pool=pool,
            tile=tile)
    if mode in ("cuda_popcount", "cuda_pm1"):
        flat, (n, oh, ow) = binary_conv.im2col_matmul(x_packed, kh, kw,
                                                      stride, pad)
        out = fused_matmul_bn_binarize(
            flat, w_packed, p, word_weights, mode=mode, planes=planes,
            cw=x_packed.shape[-1] // bitplanes.NUM_PLANES)
        out = out.reshape(n, oh, ow, out.shape[-1])
    elif mode in ("torch", "torch_pm1"):
        out = binary_conv.binary_conv2d_fused(
            x_packed, w_packed, p, kh, kw, stride, pad,
            word_weights=word_weights,
            impl="pm1" if mode == "torch_pm1" else "xor")
    else:
        raise ValueError(
            f"unknown conv mode {mode!r}; want one of {CONV_MODES}")
    if pool is not None:
        out = binary_conv.binary_or_maxpool(out, pool[0], pool[1],
                                            pad=tuple(pool[2]))
    return out


def chain_forward(x_packed: torch.Tensor, stages, stage_arrays,
                  **kw) -> torch.Tensor:
    """Run a fused conv/pool chain (one region) in a single K5 launch with
    on-chip intermediates (DESIGN.md §9); the region-level counterpart of
    :func:`fused_binary_conv2d`.  ``stage_arrays`` is the reference's
    per-conv-stage tuple, or :class:`~repro_torch.kernels.chain_conv.
    ChainOperands` already in the kernel's layout (what a region caches)."""
    stages = tuple(stages)
    if not isinstance(stage_arrays, _chain.ChainOperands):
        stage_arrays = _chain.chain_operands(stages, tuple(stage_arrays))
    return _chain.chain_conv(x_packed, stages, stage_arrays, **kw)
