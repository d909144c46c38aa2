"""K3: direct (im2col-free) fused binary conv + BN + binarize + pack, with
an optional OR-pool epilogue (DESIGN.md §5).

Port of ``repro.kernels.direct_conv_bn_binarize.direct_conv_bn_binarize``;
the CUDA kernels are in ``csrc/direct_conv_bn_binarize.cu``.  Neither
im2col patches nor unpacked counts (nor, with the pool, the pre-pool conv
map) are written to device memory.

Two wrappers, each with its own launch count:

* :func:`direct_conv_bn_binarize` — any filters.  Without word weights it
  launches the int8 tensor-core kernel (+-1 bytes, ``cnt = (32·K -
  dot)/2``); with word weights, the CUDA-core kernel.
* :func:`direct_conv_bn_binarize_planes` — the bit-plane first layer in
  its u8 x s8 form (``core.bitplanes.plane_filters``, built once when an
  executor is built): the tensor-core kernel on plane bytes.

The tensor-core kernel computes every conv position under a block's tile
of pooled outputs once, then ORs the pool windows from shared memory;
:func:`plan_mma` picks the tile and the output words a block.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core import (binary_conv, binary_ops, bitplanes,
                              layer_integration, packing)
from repro_torch.kernels import build

MMA_NW_BLOCKS = 4       # output words a block: 1 .. 4 are compiled
PLANE_STRIDE = 9        # shared words a (pixel, word) of plane bytes


@dataclasses.dataclass(frozen=True)
class MmaLimits:
    """What the card allows the tensor-core kernel: its SMs and its
    opt-in shared memory a block."""
    sms: int
    smem_block: int


@functools.lru_cache(maxsize=None)
def mma_limits(device: torch.device) -> MmaLimits:
    """The planner's limits, read once a device from the card
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, the SM count)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    smem = build.library().phonebit_smem_optin(index)
    if smem <= 0:
        raise RuntimeError(f"direct conv: cannot read the shared memory of "
                           f"{device}")
    return MmaLimits(build.sm_count(device), smem)


@dataclasses.dataclass(frozen=True)
class MmaWeights:
    """The planner's cost model, in units of one k32 step of one item (2
    m16 row tiles x one 32-channel word): staging one input word as 32
    plane bytes, one +-1 input word, one filter word.  Fitted to the
    card's times of every candidate tile at the default path's shapes
    (``tools/k3_tile_sweep.py``, then ``tools/k3_tile_fit.py``; PERF.md
    §6)."""
    plane_word: float = 0.5
    pm1_word: float = 0.0125
    filter_word: float = 0.025


MMA_WEIGHTS = MmaWeights()


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    """Tile of one tensor-core launch: (tile_h, tile_w) final outputs and
    ``nw_block`` output words a block; ``smem`` bytes and ``blocks``."""
    tile_h: int
    tile_w: int
    nw_block: int
    smem: int
    blocks: int


def _odd(v: int) -> int:
    return v | 1


def _region(th: int, tw: int, kh: int, kw: int, stride: int, pool):
    """Most conv positions (rh, rw) and input pixels (ih, iw) under a tile
    of th x tw final outputs."""
    if pool is None:
        rh, rw = th, tw
    else:
        rh, rw = ((t - 1) * pool[1] + pool[0] for t in (th, tw))
    return rh, rw, (rh - 1) * stride + kh, (rw - 1) * stride + kw


def mma_smem(th: int, tw: int, nw_block: int, *, kh: int, kw: int,
             stride: int, cw: int, pool, planes: bool) -> int:
    """Shared bytes of one block (``mma_smem_words`` in the kernel)."""
    rh, rw, ih, iw = _region(th, tw, kh, kw, stride, pool)
    a_words = ih * iw * (cw * PLANE_STRIDE if planes else _odd(cw))
    nb = 32 * nw_block
    return 4 * (nb * _odd(kh * kw * cw) + 3 * nb + kh * kw * cw + a_words
                + rh * rw * nw_block)


def mma_candidates(n: int, fh: int, fw: int, o: int, *, kh: int, kw: int,
                   stride: int, cw: int, pool, planes: bool,
                   limits: MmaLimits,
                   weights: MmaWeights = MMA_WEIGHTS
                   ) -> list[tuple[float, MmaPlan]]:
    """Every tile of up to 16 x 16 final outputs and 1-4 output words a
    block that fits the card's shared memory a block, with the model's
    cost: the busiest SM's blocks (``ceil(blocks / SMs)``) times a block's
    work — its items' k32 steps over K words, plus staging its input and
    filters, weighed by ``weights``."""
    nw = packing.num_words(o)
    k = kh * kw * cw
    in_word = weights.plane_word if planes else weights.pm1_word
    out = []
    for nwb in range(1, min(MMA_NW_BLOCKS, nw) + 1):
        groups = math.ceil(nw / nwb)
        for th in range(1, min(fh, 16) + 1):
            for tw in range(1, min(fw, 16) + 1):
                smem = mma_smem(th, tw, nwb, kh=kh, kw=kw, stride=stride,
                                cw=cw, pool=pool, planes=planes)
                if smem > limits.smem_block:
                    continue
                rh, rw, ih, iw = _region(th, tw, kh, kw, stride, pool)
                items = math.ceil(rh * rw / 32) * nwb
                work = (items * k + in_word * ih * iw * cw
                        + weights.filter_word * 32 * nwb * k)
                blocks = (n * math.ceil(fh / th) * math.ceil(fw / tw)
                          * groups)
                out.append((math.ceil(blocks / limits.sms) * work,
                            MmaPlan(th, tw, nwb, smem, blocks)))
    return out


@functools.lru_cache(maxsize=None)
def plan_mma(n: int, fh: int, fw: int, o: int, *, kh: int, kw: int,
             stride: int, cw: int, pool, planes: bool,
             limits: MmaLimits) -> MmaPlan:
    """The candidate (:func:`mma_candidates`) the model likes best; ties
    go to the larger tile (less halo), then to more words a block.
    Cached: a serving shape plans once."""
    cands = mma_candidates(n, fh, fw, o, kh=kh, kw=kw, stride=stride, cw=cw,
                           pool=pool, planes=planes, limits=limits)
    if not cands:
        raise ValueError(f"direct conv: no tile fits {limits.smem_block} B "
                         f"of shared memory (K = {kh * kw * cw} words)")
    return min(cands, key=lambda c: (c[0], -c[1].tile_h * c[1].tile_w,
                                     -c[1].nw_block))[1]


@functools.lru_cache(maxsize=None)
def plan_mma_tile(tile: tuple[int, int, int], n: int, fh: int, fw: int,
                  o: int, *, kh: int, kw: int, stride: int, cw: int, pool,
                  planes: bool, limits: MmaLimits) -> MmaPlan:
    """The plan of a given ``(tile_h, tile_w, nw_block)`` — one of
    :func:`mma_candidates` — in place of :func:`plan_mma`'s pick (an
    autotuned tile); raises for a tile that is not a candidate here."""
    for _, plan in mma_candidates(n, fh, fw, o, kh=kh, kw=kw, stride=stride,
                                  cw=cw, pool=pool, planes=planes,
                                  limits=limits):
        if (plan.tile_h, plan.tile_w, plan.nw_block) == tuple(tile):
            return plan
    raise ValueError(f"direct conv: tile {tuple(tile)} is not a candidate "
                     f"for a {fh}x{fw}x{o} output (K = {kh * kw * cw} "
                     f"words)")


def conv_geometry(h, w, kh, kw, stride, pad, pool):
    """(conv rows, conv cols, final rows, final cols) of one K3 call."""
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
    oh, ow, _, _ = conv_geometry(h, w_in, kh, kw, stride, pad, pool)
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
                            = None,
                            tile: tuple[int, int, int] | None = None
                            ) -> torch.Tensor:
    """Direct fused conv(+pool): packed NHWC in, packed NHWC out.

    x: (N, H, W, Cw) int32 (for the bit-plane first layer, Cw is the
    flattened 8*Cw plane-word dim); w_packed: (O, KH*KW*Cw) int32 in
    ``pack_conv_weights`` order; threshold (O,) int32; sign_flip (O,) bool;
    word_weights (KH*KW*Cw,) int32 or None (all ones); pool: optional
    ``(window, stride, (pad_lo, pad_hi))``.  Returns
    (N, OH', OW', ceil(O/32)) int32, pooled dims when ``pool`` is given.

    Launches a CUDA kernel for CUDA tensors — the tensor-core kernel
    without word weights, at ``tile`` (``(tile_h, tile_w, nw_block)``,
    :func:`plan_mma_tile`) or :func:`plan_mma`'s pick, the CUDA-core
    kernel with them (which takes no tile); CPU tensors take the plain
    version, whose result no tile changes.
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
        if tile is not None:
            raise ValueError("direct_conv_bn_binarize: the word-weighted "
                             "kernel takes no tile")
    if ww_ptr is None:
        out = _launch_mma(x, w_packed, None, threshold, sign_flip, cw, kh,
                          kw, stride, pad, pool, planes=False, tile=tile)
        direct_conv_bn_binarize.launches += 1
        return out
    oh, ow, fh, fw = conv_geometry(h, w_in, kh, kw, stride, pad, pool)
    window, pstride, lo = _pool_args(pool)
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


def _pool_args(pool) -> tuple[int, int, int]:
    return (1, 1, 0) if pool is None else (pool[0], pool[1], pool[2][0])


def _launch_mma(x, signs, const, threshold, sign_flip, cw: int, kh: int,
                kw: int, stride: int, pad: int, pool, planes: bool,
                plan: MmaPlan | None = None,
                tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """One launch of the tensor-core kernel on validated operands: at
    ``plan`` (the tile sweep's), else at ``tile``'s plan, else at the
    planner's pick."""
    n, h, w_in, _ = x.shape
    o = signs.shape[0]
    if pool is not None:
        pool = (pool[0], pool[1], tuple(pool[2]))
    oh, ow, fh, fw = conv_geometry(h, w_in, kh, kw, stride, pad, pool)
    if plan is None:
        geo = dict(kh=kh, kw=kw, stride=stride, cw=cw, pool=pool,
                   planes=planes, limits=mma_limits(x.device))
        plan = (plan_mma(n, fh, fw, o, **geo) if tile is None
                else plan_mma_tile(tuple(tile), n, fh, fw, o, **geo))
    window, pstride, lo = _pool_args(pool)
    out = torch.empty((n, fh, fw, packing.num_words(o)), dtype=torch.int32,
                      device=x.device)
    build.check(build.library().launch_direct_conv_mma(
        x.data_ptr(), signs.data_ptr(),
        const.data_ptr() if const is not None else None,
        threshold.data_ptr(), sign_flip.data_ptr(), out.data_ptr(), n, h,
        w_in, cw, o, kh, kw, stride, pad, oh, ow, window, pstride, lo, fh,
        fw, plan.tile_h, plan.tile_w, plan.nw_block, int(planes),
        build.stream_ptr(x.device)), "direct_conv_bn_binarize (mma)")
    return out


def direct_conv_bn_binarize_planes_plain(
        x, filters: bitplanes.PlaneFilters, threshold, sign_flip, *,
        kh: int, kw: int, stride: int = 1, pad: int = 0,
        pool=None) -> torch.Tensor:
    """The plain PyTorch version of the bit-plane variant, by the u8 x s8
    identity: each pixel's plane words become bytes
    (``bitplanes.plane_bytes``; padding is byte 0), and over KH*KW
    shifted, strided taps ``cnt = const - sum bytes · signs``; then
    threshold + pack and the OR-pool, as the generic version."""
    n, h, w_in, _ = x.shape
    o = filters.signs.shape[0]
    oh, ow, _, _ = conv_geometry(h, w_in, kh, kw, stride, pad, pool)
    u = bitplanes.plane_bytes(x)                          # N, H, W, Cw·32
    cb = u.shape[-1]
    up = F.pad(u, (0, 0, pad, pad, pad, pad)) if pad else u
    cw = cb // packing.WORD_BITS
    dot = torch.zeros((n * oh * ow, o), dtype=torch.int64, device=x.device)
    for di in range(kh):
        for dj in range(kw):
            k0 = (di * kw + dj) * cw
            tap = up[:, di:di + (oh - 1) * stride + 1:stride,
                     dj:dj + (ow - 1) * stride + 1:stride, :]
            dot += bitplanes.byte_sign_dot(tap.reshape(-1, cb),
                                           filters.signs[:, k0:k0 + cw])
    cnt = (filters.const.to(torch.int64) - dot).to(torch.int32)
    bits = layer_integration.apply_threshold(
        cnt, layer_integration.IntegratedParams(threshold, sign_flip))
    out = packing.pack_bits(bits, axis=-1).reshape(n, oh, ow, -1)
    if pool is not None:
        out = binary_conv.binary_or_maxpool(out, pool[0], pool[1],
                                            pad=tuple(pool[2]))
    return out


def direct_conv_bn_binarize_planes(
        x: torch.Tensor, filters: bitplanes.PlaneFilters,
        threshold: torch.Tensor, sign_flip: torch.Tensor, *, kh: int,
        kw: int, stride: int = 1, pad: int = 0,
        pool: tuple[int, int, tuple[int, int]] | None = None,
        tile: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The bit-plane first layer's direct fused conv(+pool): x (N, H, W,
    8·Cw) plane words, ``filters`` from ``bitplanes.plane_filters`` ->
    the words :func:`direct_conv_bn_binarize` gives for the converter's
    filters and plane word weights, bit for bit.

    Launches the tensor-core kernel on plane bytes for CUDA tensors, at
    ``tile`` or the planner's pick; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return direct_conv_bn_binarize_planes_plain(
            x, filters, threshold, sign_flip, kh=kh, kw=kw, stride=stride,
            pad=pad, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"direct_conv_bn_binarize_planes: unsupported "
                         f"device {x.device}")
    dev = x.device
    build.require(x, "x", torch.int32, 4, dev)
    build.require(filters.signs, "signs", torch.int32, 2, dev)
    build.require(filters.const, "const", torch.int32, 1, dev)
    build.require(threshold, "threshold", torch.int32, 1, dev)
    build.require(sign_flip, "sign_flip", torch.bool, 1, dev)
    o, k = filters.signs.shape
    planes_cw = x.shape[-1]
    if planes_cw % bitplanes.NUM_PLANES or \
            k != kh * kw * planes_cw // bitplanes.NUM_PLANES or \
            filters.const.shape[0] != o or threshold.shape[0] != o or \
            sign_flip.shape[0] != o:
        raise ValueError(f"direct_conv_bn_binarize_planes: signs "
                         f"{tuple(filters.signs.shape)} / const / threshold "
                         f"/ sign_flip disagree with x {tuple(x.shape)} and "
                         f"{kh}x{kw}")
    out = _launch_mma(x, filters.signs, filters.const, threshold, sign_flip,
                      planes_cw // bitplanes.NUM_PLANES, kh, kw, stride, pad,
                      pool, planes=True, tile=tile)
    direct_conv_bn_binarize_planes.launches += 1
    return out


direct_conv_bn_binarize_planes.launches = 0
