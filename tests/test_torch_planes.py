"""Port parity: the first layer's u8 x s8 form and the tensor-core
kernels' host-side planning.

The converter copies each first-layer tap's sign words into all 8 planes,
which weigh 2^p, so the layer's weighted counts are one product of input
bytes and +-1 filter bits (``core.bitplanes``):
``cnt = 255 · popcount(signs) - sum s · byte``.  Here, on the CPU:

* that identity (``bitplanes.plane_bytes`` / ``byte_sign_dot``) and the
  plain versions of K1's and K3's bit-plane variants against the JAX
  package's weighted counts (``repro.kernels.ref`` and ``ops`` in mode
  ``xla``) and the port's generic plain K1/K3, bit for bit, on random
  plane-structured filters — with input pad bits set (the kernels read
  every bit position) and on ``bitplane_pack`` output (pad bits 0), at
  AlexNet conv1's filter shape and YOLOv2-Tiny conv1's pad 1 with 16
  filters;
* the lowering step (``bitplanes.plane_filters``) against the JAX
  converter's first-layer params, and its refusal of filters whose planes
  differ or whose word weights are not 2^p;
* the tile planners (``direct_conv_bn_binarize.plan_mma``,
  ``xnor_popcount_matmul.plan_gemm``): every block's region holds every
  conv position its pool windows read, the pooled words computed from the
  regions alone equal the plain pool, the shared memory fits, and split
  reductions sum back to the counts;
* the executor's choice: the bit-plane form is built once for the first
  layer of the modes that run a variant, and never for the others.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import bnn_model as j_bnn
from repro.core import converter as j_conv
from repro.core import layer_integration as j_li
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch import workloads as t_workloads
from repro_torch.core import binary_conv as t_bc
from repro_torch.core import bitplanes as t_planes
from repro_torch.core import layer_integration as t_li
from repro_torch.core import packing as t_packing
from repro_torch.kernels import direct_conv_bn_binarize as k3
from repro_torch.kernels import xnor_popcount_matmul as k1
from repro_torch.runtime import GraphExecutor

RNG = np.random.default_rng(16)


def words(*shape) -> np.ndarray:
    return RNG.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
        .astype(np.int32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def plane_structured(o: int, taps: int, cw: int, c_real: int | None = None):
    """Random first-layer filters as the converter lays them out: (O,
    taps·8·Cw) with each tap's sign words copied into all 8 planes (pad
    bits 0 when ``c_real`` is given), and their word weights."""
    if c_real is None:
        signs = words(o, taps, cw)
    else:
        bits = RNG.integers(0, 2, (o, taps, c_real))
        signs = t_packing.pack_bits(t(bits), axis=-1).numpy()
    wp = np.repeat(signs[:, :, None, :], 8, axis=2).reshape(o, -1)
    ww = np.asarray(t_planes.plane_word_weights(cw).repeat(taps))
    return np.ascontiguousarray(wp), ww


def thresholds(o: int, ww: np.ndarray):
    mean = 16.0 * ww.sum()
    spread = 3 * np.sqrt(8.0 * (ww.astype(np.int64) ** 2).sum())
    thr = RNG.integers(int(mean - spread), int(mean + spread) + 1,
                       o).astype(np.int32)
    return thr, RNG.integers(0, 2, o).astype(bool)


# --------------------------------------------------------------------------
# The identity and K1's variant
# --------------------------------------------------------------------------

COUNT_CASES = [  # (name, M, taps, Cw, O)
    ("alexnet conv1 filters", 20, 121, 1, 96),
    ("yolo conv1 filters", 33, 9, 1, 16),
    ("two words a plane", 17, 9, 2, 40),
]


@pytest.mark.parametrize("case", COUNT_CASES, ids=[c[0] for c in COUNT_CASES])
def test_k1_planes_plain_matches_reference(case):
    """Every bit of the rows random, pad bits included: the identity holds
    for any input words."""
    _, m, taps, cw, o = case
    a = words(m, taps * 8 * cw)
    wp, ww = plane_structured(o, taps, cw)
    filters = t_planes.plane_filters(t(wp), t(ww), taps)
    got = k1.xnor_popcount_matmul_planes(t(a), filters, cw)
    assert got.dtype == torch.int32 and got.shape == (m, o)
    want = np.asarray(j_ref.xnor_popcount_matmul(a, wp, word_weights=ww))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        k1.xnor_popcount_matmul(t(a), t(wp), t(ww)).numpy(), want)


def test_plane_bytes_rebuild_each_pixel():
    """plane_bytes undoes bitplane_pack: the bytes of real channels are the
    image, pad positions 0."""
    x = RNG.integers(0, 256, (2, 3, 5, 3), dtype=np.uint8)
    planes = t_planes.pack_bitplanes(t(x)).reshape(2, 3, 5, -1)
    u = t_planes.plane_bytes(planes)
    assert u.shape == (2, 3, 5, 32)
    np.testing.assert_array_equal(u[..., :3].numpy(), x)
    assert not u[..., 3:].any()


# --------------------------------------------------------------------------
# K3's variant
# --------------------------------------------------------------------------

K3_CASES = [  # (name, (N, H, W, C), k, stride, pad, O, pool, pad bits set)
    ("alexnet conv1 shape, pool 3/2", (1, 35, 35, 3), 11, 4, 0, 96,
     (3, 2, (0, 0)), False),
    ("yolo conv1: pad 1, 16 filters, pool 2/2", (2, 12, 12, 3), 3, 1, 1, 16,
     (2, 2, (0, 0)), False),
    ("pool pad (0,1), input pad bits set", (2, 7, 7, 3), 3, 1, 1, 32,
     (2, 1, (0, 1)), True),
    ("no pool, 40 channels (2 words a plane)", (1, 9, 8, 40), 3, 2, 1, 48,
     None, True),
]


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_k3_planes_plain_matches_xla(case):
    _, (n, h, w, c), k, st, pad, o, pool, pad_bits = case
    cw = t_packing.num_words(c)
    if pad_bits:
        x = words(n, h, w, 8 * cw)
    else:
        img = RNG.integers(0, 256, (n, h, w, c), dtype=np.uint8)
        x = t_planes.pack_bitplanes(t(img)).reshape(n, h, w, -1).numpy()
    wp, ww = plane_structured(o, k * k, cw, c_real=c)
    thr, sgn = thresholds(o, ww)
    filters = t_planes.plane_filters(t(wp), t(ww), k * k)
    got = k3.direct_conv_bn_binarize_planes(
        t(x), filters, t(thr), t(sgn), kh=k, kw=k, stride=st, pad=pad,
        pool=pool)
    want = np.asarray(j_ops.fused_binary_conv2d(
        x, wp, j_li.IntegratedParams(thr, sgn), k, k, st, pad,
        word_weights=ww, mode="xla", pool=pool))
    np.testing.assert_array_equal(got.numpy(), want)
    generic = k3.direct_conv_bn_binarize(
        t(x), t(wp), t(thr), t(sgn), kh=k, kw=k, stride=st, pad=pad,
        word_weights=t(ww), pool=pool)
    np.testing.assert_array_equal(got.numpy(), generic.numpy())
    bits = t_packing.unpack_bits(got, o).float().mean().item()
    assert 0.05 < bits < 0.95, f"{bits:.3f} of output bits set"


# --------------------------------------------------------------------------
# The lowering step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("c_in,c_out,k", [(3, 96, 11), (3, 16, 3),
                                          (40, 24, 3)])
def test_plane_filters_from_the_jax_converter(c_in, c_out, k):
    """plane_filters on the JAX converter's first-layer params: one
    plane's words, and const = 255 · (+1 weights) = 255·(K + w_sum)/2."""
    spec = [j_bnn.BConv(c_in, c_out, kernel=k, stride=1, pad=1, first=True)]
    w = RNG.standard_normal((k, k, c_in, c_out)).astype(np.float32)
    params = [dict(w=w, gamma=np.ones(c_out, np.float32),
                   beta=np.zeros(c_out, np.float32),
                   mu=np.zeros(c_out, np.float32),
                   var=np.ones(c_out, np.float32))]
    packed = j_conv.convert(params, spec, (k + 2, k + 2))[0]
    wp = np.asarray(packed["w_packed"])
    filters = t_planes.plane_filters(t(wp), t(packed["word_weights"]),
                                     k * k)
    cw = t_packing.num_words(c_in)
    np.testing.assert_array_equal(
        filters.signs.numpy(), wp.reshape(c_out, k * k, 8, cw)[:, :, 3]
        .reshape(c_out, -1))
    w_sum = np.where(w >= 0, 1, -1).sum(axis=(0, 1, 2))
    np.testing.assert_array_equal(filters.const.numpy(),
                                  255 * (k * k * c_in + w_sum) // 2)
    assert filters.const.dtype == torch.int32


def test_plane_filters_refuse_other_filters():
    wp, ww = plane_structured(8, 9, 1)
    bad = wp.copy()
    bad[2, 9 * 0 + 5] ^= 1 << 7              # tap 0, plane 5 only
    with pytest.raises(ValueError, match="planes of a tap differ"):
        t_planes.plane_filters(t(bad), t(ww), 9)
    with pytest.raises(ValueError, match="word weights"):
        t_planes.plane_filters(t(wp), t(np.ones_like(ww)), 9)
    with pytest.raises(ValueError, match="word weights"):
        t_planes.plane_filters(t(wp), None, 9)
    with pytest.raises(ValueError, match="taps"):
        t_planes.plane_filters(t(wp[:, :-1]), t(ww[:-1]), 9)


# --------------------------------------------------------------------------
# The planners
# --------------------------------------------------------------------------

PLAN_CASES = [  # (name, (N, H, W, Cw), k, stride, pad, O, pool, planes)
    ("alexnet conv1", (8, 227, 227, 1), 11, 4, 0, 96, (3, 2, (0, 0)), True),
    ("alexnet conv1 batch 1", (1, 227, 227, 1), 11, 4, 0, 96,
     (3, 2, (0, 0)), True),
    ("alexnet conv2", (8, 27, 27, 3), 5, 1, 2, 256, (3, 2, (0, 0)), False),
    ("alexnet conv3", (8, 13, 13, 8), 3, 1, 1, 384, None, False),
    ("alexnet conv5", (8, 13, 13, 12), 3, 1, 1, 256, (3, 2, (0, 0)), False),
    ("yolo conv1", (2, 416, 416, 1), 3, 1, 1, 16, (2, 2, (0, 0)), True),
    ("yolo conv6 pool pad (0,1)", (2, 13, 13, 8), 3, 1, 1, 512,
     (2, 1, (0, 1)), False),
    ("yolo conv8", (2, 13, 13, 32), 3, 1, 1, 1024, None, False),
]


# An H100's limits as ``k3.mma_limits`` reads them on the card (132 SMs,
# 227 KB of opt-in shared memory a block), and a card with less of both.
H100 = k3.MmaLimits(sms=132, smem_block=232_448)
SMALL = k3.MmaLimits(sms=20, smem_block=99 * 1024)


def tile_region(fy0: int, fh: int, size: int, pool) -> tuple[int, int]:
    """Conv rows (first, last) that the tensor-core kernel computes under
    final rows fy0 .. fy0 + fh - 1 along one axis of a conv map of
    ``size`` (``conv_mma_kernel``'s cy0/cy1): the window's reach, clipped
    to the map."""
    if pool is None:
        return fy0, fy0 + fh - 1
    window, pstride, (lo, _) = pool
    return (max(0, fy0 * pstride - lo),
            min(size - 1, (fy0 + fh - 1) * pstride - lo + window - 1))


def _pooled(n: int, size: int, pool) -> int:
    if pool is None:
        return n
    window, pstride, (lo, hi) = pool
    return (n + lo + hi - window) // pstride + 1


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_mma_plan_regions_hold_every_window(case):
    """Each block's conv region (the kernel's geometry, ``tile_region``)
    lies in the map, fits the rows the planner sized shared memory for,
    and holds every in-map conv position of its pooled outputs' windows;
    the tiles cover the output once."""
    _, (n, h, w, cw), k, st, pad, o, pool, planes = case
    oh, ow = t_bc.conv_out_size(h, k, st, pad), t_bc.conv_out_size(w, k, st,
                                                                   pad)
    fh, fw = _pooled(oh, oh, pool), _pooled(ow, ow, pool)
    plan = k3.plan_mma(n, fh, fw, o, kh=k, kw=k, stride=st, cw=cw,
                       pool=pool, planes=planes, limits=H100)
    assert plan.smem <= H100.smem_block
    assert plan.smem == k3.mma_smem(plan.tile_h, plan.tile_w, plan.nw_block,
                                    kh=k, kw=k, stride=st, cw=cw, pool=pool,
                                    planes=planes)
    nw = t_packing.num_words(o)
    assert plan.blocks == n * math.ceil(fh / plan.tile_h) * math.ceil(
        fw / plan.tile_w) * math.ceil(nw / plan.nw_block)
    most = [(plan.tile_h - 1) * pool[1] + pool[0] if pool else plan.tile_h,
            (plan.tile_w - 1) * pool[1] + pool[0] if pool else plan.tile_w]
    for size, fsize, tile, cap in ((oh, fh, plan.tile_h, most[0]),
                                   (ow, fw, plan.tile_w, most[1])):
        covered = []
        for f0 in range(0, fsize, tile):
            fn = min(tile, fsize - f0)
            first, last = tile_region(f0, fn, size, pool)
            assert 0 <= first <= last < size
            assert last - first + 1 <= cap
            for f in range(f0, f0 + fn):
                covered.append(f)
                if pool is None:
                    assert first <= f <= last
                    continue
                window, pstride, (lo, _) = pool
                for i in range(window):
                    c = f * pstride - lo + i
                    if 0 <= c < size:
                        assert first <= c <= last
        assert covered == list(range(fsize))


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_mma_candidates_fit_the_limits(case):
    """Every candidate fits the card's shared memory a block, the plan is
    the cheapest candidate, a smaller card's plan fits it too, and a card
    that fits no tile raises."""
    _, (n, h, w, cw), k, st, pad, o, pool, planes = case
    oh, ow = t_bc.conv_out_size(h, k, st, pad), t_bc.conv_out_size(w, k, st,
                                                                   pad)
    fh, fw = _pooled(oh, oh, pool), _pooled(ow, ow, pool)
    kw = dict(kh=k, kw=k, stride=st, cw=cw, pool=pool, planes=planes)
    for limits in (H100, SMALL):
        cands = k3.mma_candidates(n, fh, fw, o, limits=limits, **kw)
        assert cands
        for _, plan in cands:
            assert plan.smem <= limits.smem_block
            assert plan.nw_block <= min(4, t_packing.num_words(o))
        plan = k3.plan_mma(n, fh, fw, o, limits=limits, **kw)
        assert min(c for c, _ in cands) == next(
            c for c, p in cands if p == plan)
    tiny = dataclasses.replace(SMALL, smem_block=1024)
    with pytest.raises(ValueError, match="no tile fits"):
        k3.plan_mma(n, fh, fw, o, limits=tiny, **kw)


@pytest.mark.parametrize("pool,tile", [((3, 2, (0, 0)), (2, 3)),
                                       ((2, 1, (0, 1)), (3, 2)),
                                       (None, (4, 3))])
def test_pool_from_regions_equals_plain(pool, tile):
    """The kernel's pool: conv words of each tile's region only, ORed per
    window (pool pad and out-of-map positions add nothing), equal the
    plain pool of the whole map."""
    conv = t(words(2, 11, 9, 2))
    oh, ow = conv.shape[1:3]
    want = (t_bc.binary_or_maxpool(conv, pool[0], pool[1], pad=pool[2])
            if pool else conv)
    fh, fw = want.shape[1:3]
    got = torch.zeros_like(want)
    for fy0 in range(0, fh, tile[0]):
        for fx0 in range(0, fw, tile[1]):
            th, tw = min(tile[0], fh - fy0), min(tile[1], fw - fx0)
            y0, y1 = tile_region(fy0, th, oh, pool)
            x0, x1 = tile_region(fx0, tw, ow, pool)
            region = conv[:, y0:y1 + 1, x0:x1 + 1]
            for fy in range(fy0, fy0 + th):
                for fx in range(fx0, fx0 + tw):
                    if pool is None:
                        got[:, fy, fx] = region[:, fy - y0, fx - x0]
                        continue
                    window, pstride, (lo, _) = pool
                    for i in range(window):
                        for j in range(window):
                            cy, cx = fy * pstride - lo + i, \
                                fx * pstride - lo + j
                            if 0 <= cy < oh and 0 <= cx < ow:
                                got[:, fy, fx] |= region[:, cy - y0, cx - x0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,ks,tile", [
    (24200, 96, 121, 1),       # conv1 under cuda_pm1: 64 x 96
    (5832, 256, 75, 0),        # conv2: 64 x 64
    (8, 4096, 288, 2),         # fc6 at batch 8: 16 x 128, split
    (8, 4096, 128, 2),         # fc7
    (84, 33, 9, 0),
])
def test_gemm_plan(m, n, ks, tile):
    """The tile, and slices of at least 8 staging steps (all of K when it
    is shorter) that give the grid two blocks an SM where K allows."""
    got, slices = k1.plan_gemm(m, n, ks)
    assert got == tile
    bm, bn = k1.GEMM_TILES[tile]
    blocks = math.ceil(m / bm) * math.ceil(n / bn)
    assert slices >= 1
    if slices > 1:
        assert ks // slices >= 8 * k1.KC
        assert blocks * (slices - 1) < 2 * k1.SMS
    else:
        assert blocks >= 2 * k1.SMS or ks // (8 * k1.KC) <= 1


def test_split_reduction_sums_back():
    """The kernel's split: slices of staging steps, each adding (32·W_s -
    dot_s)/2 (or const once, then -dot_s), sum to the counts."""
    a, b = words(8, 288), words(40, 288)
    _, slices = k1.plan_gemm(8, 4096, 288)
    per = math.ceil(math.ceil(288 / slices) / k1.KC) * k1.KC
    parts = [k1.xnor_popcount_matmul_plain(t(a[:, k0:k0 + per]),
                                           t(b[:, k0:k0 + per]))
             for k0 in range(0, 288, per)]
    assert len(parts) == math.ceil(288 / per) <= slices
    assert torch.equal(sum(parts), k1.xnor_popcount_matmul_plain(t(a), t(b)))


# --------------------------------------------------------------------------
# The executor's choice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,planes", [
    ("cuda_direct_pool", True), ("cuda_direct", True), ("cuda_pm1", True),
    ("torch", False), ("cuda_popcount", False), ("torch_pm1", False)])
def test_executor_builds_plane_filters_for_the_first_layer(mode, planes):
    wl = t_workloads.get("alexnet_imagenet", variant="tiny", device="cpu",
                         matmul_mode=mode)
    exe = wl.engine.engine.compile(2)
    firsts = [nid for nid, node in exe.graph.nodes.items()
              if node.attrs.get("first") and node.op.startswith("packed")]
    assert len(firsts) == 1
    assert set(exe._node_params) == (set(firsts) if planes else set())
    if planes:
        pf = exe._node_params[firsts[0]]["planes"]
        assert isinstance(pf, t_planes.PlaneFilters)
        w = exe.graph.nodes[firsts[0]].params["w_packed"]
        assert pf.signs.shape == (w.shape[0], w.shape[1] // 8)
    x = torch.from_numpy(RNG.integers(0, 256, (2, 16, 16, 3),
                                      dtype=np.uint8))
    assert torch.equal(exe(x), wl.engine.engine.legacy_call(x))


def test_executor_refuses_first_layer_filters_without_planes():
    wl = t_workloads.get("alexnet_imagenet", variant="tiny", device="cpu",
                         matmul_mode="cuda_direct_pool")
    graph = wl.engine.engine._graph.copy()
    first = next(n for n in graph.nodes.values() if n.attrs.get("first")
                 and n.op.startswith("packed"))
    w = first.params["w_packed"].clone()
    w[0, 1] ^= 1                           # tap 0, plane 1 differs
    first.params = dict(first.params, w_packed=w)
    with pytest.raises(ValueError, match="planes of a tap differ"):
        GraphExecutor(graph, "cuda_direct_pool")
    GraphExecutor(graph, "torch")          # the weighted words still run


def test_trained_graph_counts_take_the_plane_form():
    """The unfused trained graph's first conv_counts node runs K1's
    bit-plane variant (its plain version here) and equals the weighted
    counts of its generic plain version."""
    from repro_torch.core import bnn_model as t_bnn
    from repro_torch.runtime import assign_layouts
    wl = t_workloads.get("alexnet_imagenet", variant="tiny", device="cpu")
    g = assign_layouts(t_bnn.to_graph(wl.params, wl.spec, wl.input_hw))
    exe = GraphExecutor(g, "torch")
    (nid,) = exe._node_params
    node = g.nodes[nid]
    assert node.op == "conv_counts" and node.attrs["first"]
    x = torch.from_numpy(RNG.integers(0, 256, (2, 16, 16, 3),
                                      dtype=np.uint8))
    planes = g.upto(node.inputs[0])
    xp = GraphExecutor(planes, "torch")(x)
    flat, (n, oh, ow) = t_bc.im2col_matmul(xp, node.attrs["kernel"],
                                           node.attrs["kernel"],
                                           node.attrs["stride"],
                                           node.attrs["pad"])
    want = k1.xnor_popcount_matmul_plain(flat, node.params["w_packed"],
                                         node.params["word_weights"])
    got = GraphExecutor(g.upto(nid), "torch")(x)
    assert torch.equal(got, want.reshape(n, oh, ow, -1))
    assert torch.equal(exe(x), GraphExecutor(g, "torch")(x))
