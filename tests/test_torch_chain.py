"""Port parity: region-fused serving (``cuda_chain``) against the JAX package.

* Planners: ``vmem_plan``, ``plan_memory`` (tiny graphs),
  ``chain_geometry`` (hand-built paper AlexNet / YOLOv2-Tiny stages) and
  ``plan_chain_vmem`` offsets and arena equal the reference's.
* Partitions equal the reference's at ``vmem_budget=None``, at budgets
  that split a run (the reference's greedy split, with its on-chip bytes
  counted as the port counts them), and for explicit ``build_chain``
  splits.
* At the port's default (H100 shared-memory) budget the paper nets
  partition as the port's budget derivation says: AlexNet forms one
  region of its five convs with a 113,152 B arena, which the reference's
  VMEM accounting would not form at all.
* Chain output: ``cuda_chain`` on the CPU (K5's plain version) is bit-exact
  with JAX ``GraphExecutor(g, "xla")`` on the three tiny nets, at the
  whole-map tile and at tiles smaller than the map; the kernel level is
  held against the JAX per-node composition.  The reference's own Pallas
  chain kernel does not run under the installed jax (``pl.Unblocked`` is
  gone), so ``xla`` is the reference.

Tolerance: packed words exact.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import harness
from repro import runtime as j_runtime
from repro.core import binary_conv as j_conv
from repro.core import converter as j_converter
from repro.core import layer_integration as j_li
from repro.core import packing as j_pack
from repro.kernels import ops as j_ops
from repro.kernels.chain_conv import StageSpec as JStage
from repro.kernels.chain_conv import chain_geometry as j_geometry
from repro.models import paper_nets as j_nets
from repro.runtime import memory as j_memory
from repro.runtime import regions as j_regions
from repro_torch import workloads as t_workloads
from repro_torch.core import converter as t_converter
from repro_torch.core import layer_integration as t_li
from repro_torch.core import packing as t_pack
from repro_torch.kernels import chain_conv as t_chain
from repro_torch.kernels import ops as t_ops
from repro_torch.models import paper_nets as t_nets
from repro_torch.runtime import memory as t_memory
from repro_torch.runtime import regions as t_regions
from repro_torch.runtime.executor import CHAIN_BACKEND, GraphExecutor
from repro_torch.runtime.graph import lower_packed
from repro_torch.runtime.passes import fuse_pool_epilogue
from repro_torch.serving import PhoneBitEngine
from test_torch_workloads import reference, zero_artifact

RNG = np.random.default_rng(12)


def shape_graphs(j_spec, t_spec, hw):
    """The fused serving graph of one spec on both sides, from zero-filled
    artifacts (shapes only, no compute)."""
    j_packed = zero_artifact(
        j_spec, hw, j_pack.num_words, lambda s, d: jnp.zeros(s, d),
        lambda o: j_li.IntegratedParams(jnp.zeros(o, jnp.int32),
                                        jnp.zeros(o, bool)))
    t_packed = zero_artifact(
        t_spec, hw, t_pack.num_words,
        lambda s, d: torch.zeros(s, dtype=getattr(torch, d)),
        lambda o: t_li.IntegratedParams(torch.zeros(o, dtype=torch.int32),
                                        torch.zeros(o, dtype=torch.bool)))
    return (j_runtime.fuse_pool_epilogue(
                j_runtime.lower_packed(j_spec, j_packed, hw)),
            fuse_pool_epilogue(lower_packed(t_spec, t_packed, hw)))


def paper_graphs(net: str):
    j_spec, (h, w, c) = j_nets.get(net)
    t_spec, _ = t_nets.get(net)
    jg, tg = shape_graphs(j_spec, t_spec, (h, w))
    return jg, tg, (h, w, c)


def tiny_graphs(name: str):
    wl = t_workloads.get(name, variant="tiny", device="cpu")
    j_spec = harness.conformance_workload(name).spec
    jg, tg = shape_graphs(j_spec, wl.spec, wl.input_hw)
    return jg, tg, wl.input_hw + (3,)


def chain_rows(chains):
    return [(c.node_ids, tuple(dataclasses.astuple(s) for s in c.stages),
             tuple(c.in_shape), c.plan.offsets, c.plan.sizes,
             c.plan.arena_bytes) for c in chains]


@pytest.fixture
def ref_counts_arena_only(monkeypatch):
    """The reference's partitioner with its plans' ``fixed_bytes`` set to
    0 — the bytes the port's kernel keeps on chip besides the arena — so
    both sides split a run by the same rule on the same sizes."""
    plan = j_regions.plan_chain_vmem

    def arena_only(*a, **kw):
        return dataclasses.replace(plan(*a, **kw), fixed_bytes=0)

    monkeypatch.setattr(j_regions, "plan_chain_vmem", arena_only)


# --------------------------------------------------------------------------
# Planners
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,budget,fixed", [
    ([1000, 2000, 3000, 500], 10_000, 100),
    ([4 * 87 * 87 * 3, 4 * 43 * 43 * 3, 4 * 39 * 39 * 8], None, 0),
    ([2 ** 24], 2 ** 20, 0),
    ([], 128, 0),
    ([129, 1, 513, 127, 4096, 64], 4096, 7),
])
def test_vmem_plan_matches_reference(sizes, budget, fixed):
    got = t_memory.vmem_plan(sizes, budget=budget, fixed_bytes=fixed)
    want = j_memory.vmem_plan(sizes, budget=budget, fixed_bytes=fixed)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (got.fits(), got.total_bytes(), got.naive_bytes()) == \
        (want.fits(), want.total_bytes(), want.naive_bytes())


@pytest.mark.parametrize("name", harness.CONFORMANCE_NAMES)
def test_plan_memory_matches_reference(name):
    jg, tg, hwc = tiny_graphs(name)
    for batch in (1, 3):
        shape = (batch,) + hwc
        got = t_memory.plan_memory(tg, shape)
        want = j_memory.plan_memory(jg, shape)
        assert got.schedule == want.schedule
        assert got.report() == want.report()
        assert (got.peak_bytes(), got.naive_bytes(),
                got.live_peak_bytes()) == (want.peak_bytes(),
                                           want.naive_bytes(),
                                           want.live_peak_bytes())


ALEXNET_STAGES = (
    ("conv", 11, 4, 0, 0, 96, True), ("pool", 3, 2, 0, 0, 96),
    ("conv", 5, 1, 2, 2, 256), ("pool", 3, 2, 0, 0, 256),
    ("conv", 3, 1, 1, 1, 384), ("conv", 3, 1, 1, 1, 384),
    ("conv", 3, 1, 1, 1, 256), ("pool", 3, 2, 0, 0, 256))
YOLO_STAGES = (
    ("conv", 3, 1, 1, 1, 16, True), ("pool", 2, 2, 0, 0, 16),
    ("conv", 3, 1, 1, 1, 32), ("pool", 2, 2, 0, 0, 32),
    ("conv", 3, 1, 1, 1, 64), ("pool", 2, 2, 0, 0, 64),
    ("conv", 3, 1, 1, 1, 128), ("pool", 2, 2, 0, 0, 128),
    ("conv", 3, 1, 1, 1, 256), ("pool", 2, 2, 0, 0, 256),
    ("conv", 3, 1, 1, 1, 512), ("pool", 2, 1, 0, 1, 512),
    ("conv", 3, 1, 1, 1, 1024), ("conv", 3, 1, 1, 1, 1024))


@pytest.mark.parametrize("rows,hw", [(ALEXNET_STAGES, (227, 227)),
                                     (YOLO_STAGES, (416, 416)),
                                     (YOLO_STAGES[8:], (26, 26))])
@pytest.mark.parametrize("tile", [(None, None), (1, 1), (2, 3), (5, None),
                                  (100, 100)])
def test_chain_geometry_matches_reference(rows, hw, tile):
    got = t_chain.chain_geometry(tuple(t_chain.StageSpec(*r) for r in rows),
                                 *hw, *tile)
    want = j_geometry(tuple(JStage(*r) for r in rows), *hw, *tile)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("net", ["alexnet", "yolov2-tiny", "vgg16"])
@pytest.mark.parametrize("tile", [{}, dict(block_h=2, block_w=3),
                                  dict(block_h=1, block_n=4)])
def test_plan_chain_vmem_matches_reference(net, tile):
    """Same offsets, sizes and arena as the reference for every region's
    stages; ``fixed_bytes`` is 0 (the kernel keeps only the arena in
    shared memory), where the reference counts its VMEM operand blocks."""
    jg, tg, hwc = paper_graphs(net)
    chains = t_regions.partition_chains(tg, (8,) + hwc, vmem_budget=None)
    assert chains
    for c in chains:
        got = t_regions.plan_chain_vmem(c.stages, c.in_shape, tile=tile)
        want = j_regions.plan_chain_vmem(
            tuple(JStage(*dataclasses.astuple(s)) for s in c.stages),
            c.in_shape, tile=tile)
        assert (got.offsets, got.sizes, got.arena_bytes) == \
            (want.offsets, want.sizes, want.arena_bytes)
        assert got.fixed_bytes == 0 < want.fixed_bytes


# --------------------------------------------------------------------------
# Partitions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("net", ["alexnet", "yolov2-tiny", "vgg16"])
def test_unbounded_partitions_match_reference(net, batch):
    jg, tg, hwc = paper_graphs(net)
    shape = (batch,) + hwc
    got = t_regions.partition_chains(tg, shape, vmem_budget=None)
    want = j_regions.partition_chains(jg, shape, vmem_budget=None)
    assert chain_rows(got) == chain_rows(want)
    # vmem_bytes differs by the reference's fixed VMEM residents only.
    for g_row, w_row in zip(t_regions.chain_report(got),
                            j_regions.chain_report(want)):
        assert g_row.pop("vmem_bytes") == g_row["arena_bytes"]
        w_row.pop("vmem_bytes")
        assert g_row == w_row


@pytest.mark.parametrize("net,budgets", [
    ("alexnet", (60_000, 100_000, 113_152)),
    ("yolov2-tiny", (64 * 1024, 227 * 1024, 2 ** 20)),
    ("vgg16", (100_000, 227 * 1024, 2 ** 20)),
])
def test_split_partitions_match_reference(net, budgets,
                                          ref_counts_arena_only):
    jg, tg, hwc = paper_graphs(net)
    shape = (1,) + hwc
    whole = t_regions.partition_chains(tg, shape, vmem_budget=None)
    split = False
    for budget in budgets:
        got = t_regions.partition_chains(tg, shape, vmem_budget=budget)
        want = j_regions.partition_chains(jg, shape, vmem_budget=budget)
        assert chain_rows(got) == chain_rows(want), budget
        assert all(c.plan.fits() for c in got)
        split |= chain_rows(got) != chain_rows(whole)
    assert split, "no budget split a run"


@pytest.mark.parametrize("net", ["alexnet", "yolov2-tiny"])
def test_explicit_build_chain_splits_match_reference(net):
    jg, tg, hwc = paper_graphs(net)
    shape = (2,) + hwc
    (run,) = t_regions.partition_chains(tg, shape, vmem_budget=None)
    for cut in range(1, len(run.node_ids)):
        for ids in (run.node_ids[:cut], run.node_ids[cut:]):
            got = t_regions.build_chain(tg, ids, shape)
            want = j_regions.build_chain(jg, ids, shape)
            assert chain_rows([got]) == chain_rows([want])
            assert got.hbm_bytes_avoided() == want.hbm_bytes_avoided()
            assert got.signature_key() == want.signature_key()
            assert got.arena() == want.arena()


def test_default_budget_is_the_h100_shared_memory():
    assert t_regions.DEFAULT_SMEM_BUDGET == 232_448


@pytest.mark.parametrize("batch", [1, 8])
def test_default_partition_alexnet_is_one_region(batch):
    """Paper AlexNet at the port's default budget: one region of conv1-conv5
    with their pools, arena 113,152 B; the reference's accounting (entry
    tile, weights, accumulator in VMEM) forms none at that budget."""
    jg, tg, hwc = paper_graphs("alexnet")
    shape = (batch,) + hwc
    (chain,) = t_regions.partition_chains(tg, shape)
    kinds = [s.kind for s in chain.stages]
    assert kinds.count("conv") == 5 and kinds.count("pool") == 3
    assert [tg.nodes[n].op for n in chain.node_ids] == \
        ["packed_conv_pool"] * 2 + ["packed_conv"] * 2 + ["packed_conv_pool"]
    assert tg.nodes[tg.nodes[chain.head].inputs[0]].op == "bitplane_expand"
    assert chain.plan.arena_bytes == 113_152 and chain.plan.fits()
    assert j_regions.partition_chains(
        jg, shape, vmem_budget=t_regions.DEFAULT_SMEM_BUDGET) == []


@pytest.mark.parametrize("net,arenas,convs_outside", [
    ("yolov2-tiny", [224_896, 141_184], 1),
    ("vgg16", [222_848, 194_816], 5),
])
def test_default_partition_other_paper_nets(net, arenas, convs_outside):
    _, tg, hwc = paper_graphs(net)
    chains = t_regions.partition_chains(tg, (8,) + hwc)
    assert [c.plan.arena_bytes for c in chains] == arenas
    members = {n for c in chains for n in c.node_ids}
    outside = [n for n, node in tg.nodes.items()
               if node.op.startswith("packed_conv") and n not in members]
    assert len(outside) == convs_outside
    if net == "yolov2-tiny":
        # conv4-conv8, with the stride-1 pool padded (0, 1).
        assert [s.kind for s in chains[1].stages].count("conv") == 5
        assert any(s.kind == "pool" and (s.pad_lo, s.pad_hi) == (0, 1)
                   for s in chains[1].stages)


# --------------------------------------------------------------------------
# Chain output
# --------------------------------------------------------------------------

def words(*shape) -> np.ndarray:
    return RNG.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
        .astype(np.int32)


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


THREE_STAGE = (t_chain.StageSpec("conv", 3, 1, 1, 1, channels=48),
               t_chain.StageSpec("pool", 2, 2, channels=48),
               t_chain.StageSpec("conv", 3, 2, 1, 1, channels=40),
               t_chain.StageSpec("pool", 2, 1, 0, 1, channels=40),
               t_chain.StageSpec("conv", 1, 1, 0, 0, channels=64))


@pytest.fixture(scope="module")
def kernel_case():
    """A weighted first stage (bit-plane word weights), a stride-2 conv
    with O not a multiple of 32, a padded stride-1 pool and a 1x1 tail;
    the JAX per-node ``xla`` composition is the reference."""
    x = words(3, 12, 11, 2)
    arrays, y, cin = [], jnp.asarray(x), 2
    for st in THREE_STAGE:
        if st.kind == "pool":
            y = j_conv.binary_or_maxpool(y, st.kernel, st.stride,
                                         pad=(st.pad_lo, st.pad_hi))
            continue
        k = st.kernel * st.kernel * cin
        ww = None if arrays else RNG.integers(1, 9, k).astype(np.int32)
        mean = 16 * (k if ww is None else int(ww.sum()))
        thr = RNG.integers(int(mean * .9), int(mean * 1.1),
                           st.channels).astype(np.int32)
        sgn = RNG.integers(0, 2, st.channels).astype(bool)
        w = words(st.channels, k)
        arrays += [w, ww, thr, sgn]
        y = j_ops.fused_binary_conv2d(
            y, jnp.asarray(w), j_li.IntegratedParams(jnp.asarray(thr),
                                                     jnp.asarray(sgn)),
            st.kernel, st.kernel, st.stride, st.pad_lo,
            word_weights=None if ww is None else jnp.asarray(ww),
            mode="xla")
        cin = t_pack.num_words(st.channels)
    ref = np.asarray(y)
    share = np.unpackbits(ref.view(np.uint8)).mean()
    assert 0.2 < share < 0.8, share
    return t(x), tuple(t(a) for a in arrays), ref


@pytest.mark.parametrize("tile", [
    {}, dict(block_h=1), dict(block_h=2, block_w=1),
    dict(block_h=1, block_w=2, block_n=2), dict(block_n=3)])
def test_chain_forward_matches_per_node_xla(kernel_case, tile):
    x, arrays, ref = kernel_case
    got = t_ops.chain_forward(x, THREE_STAGE, arrays, **tile)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_planned_arena_reuse_is_exact(kernel_case):
    """At the planner's offsets (interior buffers ping-pong) the output is
    the dense layout's, and the arena is smaller than the no-reuse sum."""
    x, arrays, ref = kernel_case
    plan = t_regions.plan_chain_vmem(THREE_STAGE, tuple(x.shape))
    assert len(plan.offsets) == 4
    assert plan.arena_bytes < plan.naive_bytes()
    ops = t_chain.chain_operands(THREE_STAGE, arrays)
    got = t_chain.chain_conv(
        x, THREE_STAGE, ops, arena_offsets=tuple(o // 4
                                                 for o in plan.offsets),
        arena_words=plan.arena_bytes // 4)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_chain_operands_pad_channels_to_words(kernel_case):
    _, arrays, _ = kernel_case
    ops = t_chain.chain_operands(THREE_STAGE, arrays)
    w_t, t_pad, s_pad = ops.w_t[1], ops.t[1], ops.s[1]   # 40 -> 64 channels
    assert tuple(w_t.shape) == (9 * 2, 64) and w_t.is_contiguous()
    assert torch.equal(w_t[:, :40], arrays[4].t())
    assert not w_t[:, 40:].any()
    assert (t_pad[40:] == -1).all() and not s_pad[40:].any()
    assert ops.ww[1] is None and torch.equal(ops.ww[0], arrays[1])
    with pytest.raises(ValueError, match="conv stages"):
        t_chain.chain_operands(THREE_STAGE, arrays[:4])


def test_chain_wrapper_counts_launches_only_on_the_card(kernel_case):
    x, arrays, _ = kernel_case
    before = t_chain.chain_conv.launches
    t_ops.chain_forward(x, THREE_STAGE, arrays)
    assert t_chain.chain_conv.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        t_chain.chain_conv(x.to("meta"), THREE_STAGE,
                           t_chain.chain_operands(THREE_STAGE, arrays))


NET_TILES = {
    "alexnet_imagenet": [{}, dict(block_h=1, block_w=1)],
    "vgg16_imagenet": [{}, dict(block_h=3, block_w=2, block_n=2)],
    "yolov2_tiny_voc": [{}, dict(block_h=3, block_w=5)],
}


@pytest.mark.parametrize("name,tile", [(n, tl) for n, tiles in
                                       NET_TILES.items() for tl in tiles])
def test_cuda_chain_graph_matches_xla(name, tile):
    """The port's region executor on the CPU (K5's plain version) against
    JAX ``GraphExecutor(g, "xla")``, from the same converted params, at
    the whole-map tile and at a tile smaller than the map."""
    ref = reference(name)
    wl = t_workloads.get(name, variant="tiny", device="cpu")
    spec, hw = wl.spec, wl.input_hw
    j_spec = harness.conformance_workload(name).spec
    jg = j_runtime.fuse_pool_epilogue(j_runtime.lower_packed(
        j_spec, j_converter.convert(
            [{k: jnp.asarray(v) for k, v in p.items()}
             for p in ref["params"]], j_spec, hw), hw))
    tg = fuse_pool_epilogue(lower_packed(
        spec, t_converter.convert(ref["params"], spec, hw), hw))
    x = ref["x"]
    exe = t_regions.chain_executor(tg, x.shape)
    assert exe.regions, "no region formed"
    for chain in exe.regions:
        chain.tile = dict(tile)
        geo = t_chain.chain_geometry(chain.stages, *chain.in_shape[1:3],
                                     tile.get("block_h"),
                                     tile.get("block_w"))
        if tile.get("block_h"):
            assert geo.out_tile[-1] != geo.final_hw    # really tiled
    got = exe(torch.from_numpy(x))
    want = j_runtime.GraphExecutor(jg, "xla")(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # The packed tail, exactly: run the graph up to the last region.
    last = exe.regions[-1].tail
    got_tail = _run_to(exe, torch.from_numpy(x), last)
    want_tail = _run_to_jax(jg, jnp.asarray(x), last)
    np.testing.assert_array_equal(got_tail.numpy(), want_tail)


def _run_to(exe, x, stop):
    """The port executor's value of node ``stop`` (regions included)."""
    g = exe.graph.copy()
    g.output_id = stop
    return GraphExecutor(g, CHAIN_BACKEND, regions=exe.regions)(x)


def _run_to_jax(jg, x, stop):
    g = jg.copy()
    g.output_id = stop
    return np.asarray(j_runtime.GraphExecutor(g, "xla")(x))


@pytest.mark.parametrize("name", harness.CONFORMANCE_NAMES)
def test_engine_cuda_chain_cross_check(name):
    ref = reference(name)
    wl = t_workloads.get(name, variant="tiny", device="cpu")
    eng = PhoneBitEngine.from_trained(ref["params"], wl.spec, wl.input_hw,
                                      matmul_mode="cuda_chain",
                                      device="cpu")
    x = torch.from_numpy(ref["x"])
    np.testing.assert_allclose(eng.cross_check(x).numpy(), ref["raw"],
                               rtol=0, atol=1e-4)
    builds = eng.build_count
    eng(x)
    assert eng.build_count == builds
    rows = eng.backend_choices
    assert [r["backend"] for r in rows if r["op"] == "chain"] == \
        ["cuda_chain"]
    assert all(r["backend"] == "cuda_popcount" for r in rows
               if r["op"] == "packed_dense")
    j_plan = j_runtime.plan_memory(tiny_graphs(name)[0], eng._plan_shape())
    assert eng.memory_plan().report() == j_plan.report()


def test_executor_rejects_overlapping_regions():
    _, tg, hwc = paper_graphs("alexnet")
    (chain,) = t_regions.partition_chains(tg, (1,) + hwc)
    sub = t_regions.build_chain(tg, chain.node_ids[1:3], (1,) + hwc)
    with pytest.raises(ValueError, match="overlap"):
        GraphExecutor(tg, CHAIN_BACKEND, regions=[chain, sub])


# --------------------------------------------------------------------------
# K5's cluster shares: how the C blocks of a cluster split each stage
# --------------------------------------------------------------------------

SHARE_NETS = ("alexnet", "yolov2-tiny") + harness.CONFORMANCE_NAMES
SHARE_TILES = [{}, dict(block_h=2, block_w=3)]


@functools.lru_cache(maxsize=None)
def share_regions(net: str):
    """(stages, entry shape) of every region the port forms: the paper
    nets at batch 8 under the default budget, the tiny nets at batch 2."""
    if net in ("alexnet", "yolov2-tiny"):
        _, tg, hwc = paper_graphs(net)
        chains = t_regions.partition_chains(tg, (8,) + hwc)
    else:
        _, tg, hwc = tiny_graphs(net)
        chains = t_regions.partition_chains(tg, (2,) + hwc,
                                            vmem_budget=None)
    assert chains
    return [(c.stages, tuple(c.in_shape)) for c in chains]


def region_shares(net, tile, cluster):
    """Per region: stages, geometry, word counts and shares."""
    for stages, (_, h, w, cw) in share_regions(net):
        geo = t_chain.chain_geometry(stages, h, w, tile.get("block_h"),
                                     tile.get("block_w"))
        cws = t_chain.chain_word_counts(stages, cw)
        yield stages, geo, cws, t_chain.chain_shares(geo, cws, cluster)


@pytest.mark.parametrize("tile", SHARE_TILES)
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("net", SHARE_NETS)
def test_chain_shares_cover_each_valid_position_once(net, cluster, tile):
    """The ranks' rows (or words) partition the stage's computed rows (or
    output words), and those rows hold every row any tile of the grid
    computes; rows are shared when there are at least as many as ranks."""
    for _, geo, cws, shares in region_shares(net, tile, cluster):
        gh = -(-geo.final_hw[0] // geo.out_tile[-1][0])
        for k, sh in enumerate(shares):
            assert len(sh.bounds) == cluster
            lo, hi = sh.rows if sh.by_rows else (0, cws[k + 1])
            assert [b[0] for b in sh.bounds] == [lo] + [
                b[1] for b in sh.bounds[:-1]]
            assert sh.bounds[-1][1] == hi
            assert sh.by_rows == (sh.rows[1] - sh.rows[0] >= cluster)
            th = geo.out_tile[k][0]
            assert 0 <= sh.rows[0] < sh.rows[1] <= th
            for gi in range(gh):
                origin = gi * geo.out_step[k][0] - geo.out_off[k][0]
                rows = [r for r in range(th)
                        if 0 <= origin + r < geo.valid_hw[k][0]]
                assert rows and sh.rows[0] <= rows[0] and \
                    rows[-1] < sh.rows[1]


@pytest.mark.parametrize("tile", SHARE_TILES)
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("net", SHARE_NETS)
def test_chain_shares_are_even(net, cluster, tile):
    for _, _, cws, shares in region_shares(net, tile, cluster):
        for sh in shares:
            sizes = [b - a for a, b in sh.bounds]
            assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("tile", SHARE_TILES)
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("net", SHARE_NETS)
def test_chain_gather_stays_in_the_previous_tile(net, cluster, tile):
    """Every block a rank gathers lies in the previous stage's output tile
    and in its owner's share; and every computed word a rank's share reads
    is its own or gathered (the rest of its window is masked, held as
    0-words)."""
    for stages, geo, cws, shares in region_shares(net, tile, cluster):
        for k in range(1, len(stages)):
            st, sh, prev = stages[k], shares[k], shares[k - 1]
            th_prev = geo.out_tile[k - 1][0]
            owner = {}
            for o, (a, b) in enumerate(prev.bounds):
                rows = range(a, b) if prev.by_rows else range(*prev.rows)
                words = range(cws[k]) if prev.by_rows else range(a, b)
                owner.update({(r, g): o for r in rows for g in words})
            for rank in range(cluster):
                got = set()
                for o, (r0, r1), (g0, g1) in t_chain.chain_gather(
                        stages, geo, cws, shares, k, rank):
                    assert o != rank
                    assert 0 <= r0 < r1 <= th_prev
                    assert 0 <= g0 < g1 <= cws[k]
                    cells = {(r, g) for r in range(r0, r1)
                             for g in range(g0, g1)}
                    assert all(owner[c] == o for c in cells)
                    got |= cells
                lo, hi = sh.bounds[rank] if sh.by_rows else sh.rows
                w0, w1 = (0, cws[k + 1]) if sh.by_rows else sh.bounds[rank]
                if lo >= hi or w0 >= w1:
                    assert not got
                    continue
                words = (range(cws[k]) if st.kind == "conv" or sh.by_rows
                         else range(w0, w1))
                reads = {(r, g)
                         for r in range(lo * st.stride,
                                        (hi - 1) * st.stride + st.kernel)
                         for g in words if (r, g) in owner}
                assert {c for c in reads if owner[c] != rank} == got
