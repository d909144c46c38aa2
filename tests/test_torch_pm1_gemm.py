"""Port parity: the planner and the split reduction of the +-1 mainloop
that K6 (``mxu_pm1_matmul``) and K2 (``fused_matmul_bn_binarize`` without
word weights) share (``kernels/csrc/pm1_gemm.cuh``).

On the CPU, with seeded numpy words:

* ``pm1_gemm.plan_pm1``: the swapped, cluster-split route for the dense
  layers at small batch, the 64 x 64 ``wgmma`` tile otherwise, split only
  while every block keeps an SM of its own; every slice of the split has
  a word, the cluster is at most 4 blocks, and the grid covers M x N
  exactly; the picks at AlexNet's buckets are the splits the sweep timed;
* the kernel's arithmetic, emulated: ``pm1_pair_strided``'s bytes give the
  +-1 dot of two words; partial dots per word slice at the planner's
  boundaries, each over its zero-filled ring steps less 32 a zero word,
  summed, then K6's epilogue or K2's threshold and pack (the quad OR of the
  register epilogue, or the ballot of the reduced one) equal the JAX
  package's ``mxu_pm1_matmul`` and ``fused_matmul_bn_binarize`` in
  interpret mode and the port's plain versions, exactly;
* the quad OR-reduction packing against ``packing.pack_bits``.

The CUDA kernels are held against their plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels import fused_conv_bn_binarize as j_fused
from repro.kernels import mxu_pm1_matmul as j_k6
from repro_torch.core import packing
from repro_torch.kernels import pm1_gemm
from repro_torch.kernels.fused_conv_bn_binarize import \
    fused_matmul_bn_binarize_plain
from repro_torch.kernels.mxu_pm1_matmul import mxu_pm1_matmul_plain

RNG = np.random.default_rng(17)


def words(*shape) -> np.ndarray:
    return RNG.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
        .astype(np.int32)


def pm1(w: np.ndarray) -> np.ndarray:
    """(R, W) words -> (R, 32·W) int64 +-1, bit k of word k // 32."""
    bits = (w.astype(np.int64)[..., None] >> np.arange(32)) & 1
    return (2 * bits - 1).reshape(w.shape[0], -1)


# --------------------------------------------------------------------------
# plan_pm1
# --------------------------------------------------------------------------

PLAN_SHAPES = [  # (M, N, W): AlexNet batch 8, the buckets, edge cases
    (5832, 256, 75), (1352, 384, 72), (1352, 384, 108), (1352, 256, 108),
    (8, 4096, 288), (8, 4096, 128), (1, 4096, 288), (4, 4096, 128),
    (16, 4096, 288), (17, 4096, 288), (37, 48, 13), (8, 512, 2),
    (8, 1000, 128), (65, 70, 18), (86528, 32, 9), (8, 16, 524289),
]


@pytest.mark.parametrize("m,n,w", PLAN_SHAPES)
def test_plan_routes_slices_and_grid(m, n, w):
    plan = pm1_gemm.plan_pm1(m, n, w)
    tile = pm1_gemm.TILES[plan.tile]
    assert plan.swap == (m <= pm1_gemm.SWAP_MAX_M)
    if plan.swap:
        assert m <= tile.by and tile.bx % 32 == 0
        # Enough blocks for every SM, unless the cluster is at its cap.
        assert (plan.grid(m, n)[0] >= pm1_gemm.SMS
                or plan.cluster == min(pm1_gemm.MAX_CLUSTER,
                                       w // pm1_gemm.granule(w)))
    else:
        assert plan.tile == pm1_gemm.WGMMA_TILE and tile.wgmma
        # Every block an SM of its own, and no larger split would keep that.
        blocks = plan.grid(m, n)[0] * plan.grid(m, n)[1]
        assert plan.cluster == 1 or blocks <= pm1_gemm.SMS
        assert (2 * plan.cluster > min(pm1_gemm.MAX_CLUSTER,
                                       w // pm1_gemm.granule(w))
                or 2 * blocks > pm1_gemm.SMS)
    assert 1 <= plan.cluster <= pm1_gemm.MAX_CLUSTER
    bounds = pm1_gemm.slice_bounds(w, plan.cluster)
    assert bounds[0][0] == 0 and bounds[-1][1] == w
    assert all(e > b for b, e in bounds)
    assert all(e == b2 for (_, e), (b2, _) in zip(bounds, bounds[1:]))
    gx, gy = plan.grid(m, n)
    rows_x, rows_y = (n, m) if plan.swap else (m, n)
    tiles_x = gx // plan.cluster
    assert gx % plan.cluster == 0
    assert (tiles_x - 1) * tile.bx < rows_x <= tiles_x * tile.bx
    assert (gy - 1) * tile.by < rows_y <= gy * tile.by


# (layer, M a batch row, N, W, cluster at batch 1, 2, 4, 8): AlexNet's K6
# calls on cuda_pm1 at each bucket, and the split tools/pm1_sweep.py timed
# fastest there (PERF.md), but at conv3, where the rule's split is 3-5%
# behind no split.
BUCKET_PLANS = [("conv2", 729, 256, 75, (2, 1, 1, 1)),
                ("conv3", 169, 384, 72, (4, 2, 2, 1)),
                ("conv4", 169, 384, 108, (4, 2, 2, 1)),
                ("conv5", 169, 256, 108, (4, 4, 2, 1)),
                ("fc6", 1, 4096, 288, (2, 2, 2, 2)),
                ("fc7", 1, 4096, 128, (2, 2, 2, 2))]


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("layer,rows,n,w,clusters", BUCKET_PLANS,
                         ids=[c[0] for c in BUCKET_PLANS])
def test_plan_at_alexnet_buckets(layer, rows, n, w, clusters, batch):
    plan = pm1_gemm.plan_pm1(rows * batch, n, w, 132)
    want_tile = pm1_gemm.SWAP_8 if layer.startswith("fc") \
        else pm1_gemm.WGMMA_TILE
    assert plan == pm1_gemm.Plan(want_tile,
                                 clusters[(1, 2, 4, 8).index(batch)])


@pytest.mark.parametrize("w,cluster", [(288, 2), (75, 8), (9, 8), (13, 8),
                                       (8, 2), (4, 1)])
def test_slice_bounds_cut_at_the_granule(w, cluster):
    g = pm1_gemm.granule(w)
    bounds = pm1_gemm.slice_bounds(w, cluster)
    assert len(bounds) == cluster
    assert all(b % g == 0 for b, _ in bounds)
    sizes = [e - b for b, e in bounds]
    assert max(sizes) - min(sizes) <= g and sum(sizes) == w


def test_plan_is_cached():
    pm1_gemm.plan_pm1.cache_clear()
    pm1_gemm.plan_pm1(8, 4096, 288, 132)
    pm1_gemm.plan_pm1(8, 4096, 288, 132)
    assert pm1_gemm.plan_pm1.cache_info().hits == 1


# --------------------------------------------------------------------------
# The kernel's arithmetic, emulated
# --------------------------------------------------------------------------

def strided_pair(w: np.ndarray, t: int) -> tuple[np.ndarray, np.ndarray]:
    """``bitmma.cuh`` ``pm1_pair_strided`` on uint32 words: (lo, hi)."""
    z = ~w.astype(np.uint32)
    lo = ((z >> np.uint32(t)) & np.uint32(0x01010101)) * np.uint32(0xFE) \
        + np.uint32(0x01010101)
    hi = ((z >> np.uint32(t + 4)) & np.uint32(0x01010101)) \
        * np.uint32(0xFE) + np.uint32(0x01010101)
    return lo, hi


def s8_bytes(r: np.ndarray) -> np.ndarray:
    return r.astype(np.uint32).view(np.uint8).view(np.int8).astype(np.int64)


def test_strided_pairs_give_the_pm1_dot():
    """Over the quad's four threads, the s8 products of the two operands'
    strided registers sum to the +-1 dot of the words, zero words
    included."""
    a = words(4096).view(np.uint32)
    b = words(4096).view(np.uint32)
    a[:8] = 0
    b[:4] = 0
    dot = np.zeros(a.shape, np.int64)
    for t in range(4):
        for ra, rb in zip(strided_pair(a, t), strided_pair(b, t)):
            dot += (s8_bytes(ra).reshape(-1, 4)
                    * s8_bytes(rb).reshape(-1, 4)).sum(-1)
    popc = np.array([bin(int(x)).count("1") for x in a ^ b])
    np.testing.assert_array_equal(dot, 32 - 2 * popc)


def emulate_dot(a: np.ndarray, b: np.ndarray,
                plan: pm1_gemm.Plan) -> np.ndarray:
    """The (M, N) dots as the kernel forms them: in its orientation, one
    partial per word slice of the cluster, each over ``ceil(words / kw)``
    ring steps whose words past the slice are zero in both operands (+32
    each), less 32 a zero word; summed as the leader sums them."""
    tile = pm1_gemm.TILES[plan.tile]
    x, y = (b, a) if tile.swap else (a, b)
    total = np.zeros((x.shape[0], y.shape[0]), np.int64)
    for beg, end in pm1_gemm.slice_bounds(a.shape[1], plan.cluster):
        width = math.ceil((end - beg) / tile.kw) * tile.kw
        xs = np.zeros((x.shape[0], width), np.int32)
        ys = np.zeros((y.shape[0], width), np.int32)
        xs[:, :end - beg] = x[:, beg:end]
        ys[:, :end - beg] = y[:, beg:end]
        total += pm1(xs) @ pm1(ys).T - 32 * (width - (end - beg))
    return total.T if tile.swap else total


def quad_or_pack(bits: np.ndarray) -> np.ndarray:
    """The register epilogue's packing of (M, N) bits: a warp's 32
    columns are 4 n8 tiles; lane (g, t) sets bits 8j + 2t + e of its
    rows' words, and the quad ORs them (``__shfl_xor_sync`` by 1 and 2)."""
    m, n = bits.shape
    nw = packing.num_words(n)
    full = np.zeros((m, 32 * nw), np.int64)
    full[:, :n] = bits
    out = np.zeros((m, nw), np.int64)
    for gw in range(nw):
        lanes = np.zeros((m, 4), np.int64)
        for t in range(4):
            for j in range(4):
                for e in range(2):
                    k = 8 * j + 2 * t + e
                    lanes[:, t] |= full[:, 32 * gw + k] << k
        lanes |= lanes[:, [1, 0, 3, 2]]           # xor-shuffle by 1
        lanes |= lanes[:, [2, 3, 0, 1]]           # xor-shuffle by 2
        assert (lanes == lanes[:, :1]).all()
        out[:, gw] = lanes[:, 0]
    return out.astype(np.uint32).view(np.int32)


def ballot_pack(bits: np.ndarray) -> np.ndarray:
    """The reduced epilogue's packing: lane j's bit is channel 32g + j."""
    m, n = bits.shape
    nw = packing.num_words(n)
    full = np.zeros((m, 32 * nw), np.int64)
    full[:, :n] = bits
    out = (full.reshape(m, nw, 32) << np.arange(32)).sum(-1)
    return out.astype(np.uint32).view(np.int32)


# (name, M, N, W, pad bits a row, plan): every route, with the pad bits of
# the words' tail zero in both operands (im2col pad channels).  The slice
# case puts its last rank's whole slice on pad words.
SPLIT_CASES = [
    ("swapped, cluster 2", 8, 96, 24, 0, pm1_gemm.Plan(0, 2)),
    ("swapped, M 1, pad bits", 1, 64, 12, 40, pm1_gemm.Plan(0, 4)),
    ("swapped 16 rows, N 48", 13, 48, 20, 0, pm1_gemm.Plan(1, 2)),
    ("a slice of only pad words", 8, 40, 8, 64, pm1_gemm.Plan(0, 4)),
    ("wgmma, unsplit, N 48", 70, 48, 9, 7, pm1_gemm.Plan(2, 1)),
    ("wgmma, cluster 8", 37, 48, 13, 0, pm1_gemm.Plan(2, 8)),
    ("wgmma, cluster 2", 70, 64, 20, 0, pm1_gemm.Plan(2, 2)),
    ("planner's fc-shaped pick", 8, 256, 36, 0, None),
    ("planner's conv-shaped pick", 100, 64, 27, 5, None),
]


def split_inputs(m, n, w, pad):
    a, b = words(m, w), words(n, w)
    k_valid = 32 * w - pad
    for x in (a, b):                       # pad bits of the tail: 0
        bits = (x.astype(np.int64)[..., None] >> np.arange(32)) & 1
        bits = bits.reshape(x.shape[0], -1)
        bits[:, k_valid:] = 0
        x[...] = (bits.reshape(x.shape[0], w, 32) << np.arange(32)).sum(-1) \
            .astype(np.uint32).view(np.int32)
    return a, b, k_valid


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_reduction_k6(case):
    _, m, n, w, pad, plan = case
    plan = plan or pm1_gemm.plan_pm1(m, n, w)
    a, b, k_valid = split_inputs(m, n, w, pad)
    got = emulate_dot(a, b, plan) - (32 * w - k_valid)
    np.testing.assert_array_equal(
        got, np.asarray(j_k6.mxu_pm1_matmul(
            a, b, k_valid=k_valid, block_m=8, block_n=8, block_k=4,
            interpret=True)))
    np.testing.assert_array_equal(
        got, mxu_pm1_matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  k_valid).numpy())


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_reduction_k2(case):
    _, m, n, w, pad, plan = case
    plan = plan or pm1_gemm.plan_pm1(m, n, w)
    a, b, _ = split_inputs(m, n, w, pad)
    cnt = (32 * w - emulate_dot(a, b, plan)) >> 1
    thr = RNG.integers(int(cnt.mean()) - 8, int(cnt.mean()) + 9, n) \
        .astype(np.int32)
    sgn = RNG.integers(0, 2, n).astype(bool)
    bits = (cnt <= thr[None]) ^ sgn[None]
    registers = not plan.swap and plan.cluster == 1
    got = quad_or_pack(bits) if registers else ballot_pack(bits)
    share = bits.mean()
    assert 0.1 < share < 0.9, share
    np.testing.assert_array_equal(
        got, np.asarray(j_fused.fused_matmul_bn_binarize(
            a, b, thr, sgn, block_m=8, block_n=32, block_k=8,
            interpret=True)))
    np.testing.assert_array_equal(
        got, fused_matmul_bn_binarize_plain(
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(thr),
            torch.from_numpy(sgn)).numpy())


@pytest.mark.parametrize("m,n", [(16, 32), (5, 48), (3, 100), (1, 1)])
def test_quad_or_pack_equals_pack_bits(m, n):
    bits = RNG.integers(0, 2, (m, n))
    want = packing.pack_bits(torch.from_numpy(bits), axis=-1).numpy()
    np.testing.assert_array_equal(quad_or_pack(bits), want)
    np.testing.assert_array_equal(ballot_pack(bits), want)
