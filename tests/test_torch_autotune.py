"""Port parity: the autotuner and its executor plumbing against the JAX
package.

* An ``Autotuner(candidates=("torch", "torch_pm1"))`` executor on the
  tiny workloads: its packed tail equals the JAX package's bit for bit
  and its raw output the JAX ``xla`` executor's (the harness tolerance),
  as does the engine under ``matmul_mode="auto"``.
* Outcomes: with ``_time_node`` / ``_time_chain`` stubbed by one fixed
  table on both sides (the JAX ``Autotuner`` by monkeypatch), the
  sequence of outcomes (miss, hit, xfer_hit, disk_hit, disk_miss after a
  stamp change) and the winners agree for the same graph and buckets.
* K3 tiles: the candidates are distinct ``mma_candidates`` entries with
  ``plan_mma``'s pick first; a forced tile reaches ``eval_node`` and shows
  in ``backend_report``; on the CPU it leaves the output unchanged.
* On a CUDA device ``default_candidates`` holds no plain backend.
* ``chain_executor(tuner=...)`` equals JAX ``xla`` (not ``vpu_chain``,
  which raises under the installed jax).

Every test points ``REPRO_AUTOTUNE_CACHE`` at a ``tmp_path`` file or 0.
"""

import functools
import json
import zlib

import jax
import numpy as np
import pytest
import torch

import harness
from repro import runtime as j_runtime
from repro.obs import metrics as j_metrics
from repro.runtime import autotune as j_autotune
from repro_torch import workloads as t_workloads
from repro_torch.kernels import direct_conv_bn_binarize as k3
from repro_torch.kernels.ops import JAX_MODE
from repro_torch.obs import metrics
from repro_torch.runtime import autotune, executor, regions
from repro_torch.runtime.executor import GraphExecutor
from repro_torch.runtime.graph import infer_types

NAMES = harness.CONFORMANCE_NAMES
PLAIN = ("torch", "torch_pm1")
# The harness's float-head tolerance (packed words are compared exactly).
FLOAT_ATOL = 1e-4
# An H100's limits, for the tile planner off the card.
H100 = k3.MmaLimits(sms=132, smem_block=232448)


@pytest.fixture(autouse=True)
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    return path


@functools.lru_cache(maxsize=None)
def reference(name: str) -> dict:
    """The JAX side: params (numpy) under the golden fixtures' threefry
    setting, the seeded input, the ``xla`` raw output and packed tail."""
    with jax.threefry_partitionable(False):
        wl = harness.conformance_workload(name)
        params = [{k: np.asarray(v) for k, v in p.items()}
                  for p in wl.params]
    x = np.array(harness.seeded_batch(wl))
    return dict(params=params, x=x, raw=np.asarray(wl.engine.raw(x)),
                packed_tail=harness.packed_tail(wl, x))


def port_workload(name: str, mode: str = "torch"):
    kw = dict(variant="tiny", device="cpu", matmul_mode=mode,
              params=reference(name)["params"])
    if name == "yolov2_tiny_voc":
        kw["detect"] = t_workloads.DetectConfig(
            score_thresh=harness.CONFORMANCE_DETECT.score_thresh,
            iou_thresh=harness.CONFORMANCE_DETECT.iou_thresh,
            max_det=harness.CONFORMANCE_DETECT.max_det)
    return t_workloads.get(name, **kw)


def tail_graph(g):
    """``g`` cut at its last packed node (the input of the float head)."""
    unpack = next(n for n in g.nodes.values() if n.op == "unpack_pm1")
    return g.upto(unpack.inputs[0])


def both_graphs(name: str):
    """The same fused graph on both sides, from the same params."""
    ref = reference(name)
    wl = port_workload(name)
    eng = wl.engine.engine
    with jax.threefry_partitionable(False):
        j_eng = harness.conformance_workload(name).engine.engine
    return eng, j_eng, ref


# --------------------------------------------------------------------------
# Bit-exact against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_tuned_executor_matches_reference(name):
    ref = reference(name)
    eng = port_workload(name).engine.engine
    x = torch.from_numpy(ref["x"])
    tuner = autotune.Autotuner(candidates=PLAIN, device="cpu", warmup=0,
                               iters=1)
    tail = tuner.tuned_executor(tail_graph(eng._graph), tuple(x.shape))
    np.testing.assert_array_equal(tail(x).numpy(), ref["packed_tail"])
    exe = tuner.tuned_executor(eng._graph, tuple(x.shape))
    assert set(exe.backends.values()) <= set(PLAIN)
    np.testing.assert_allclose(exe(x).numpy(), ref["raw"], rtol=0,
                               atol=FLOAT_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_auto_engine_matches_reference(name):
    ref = reference(name)
    wl = port_workload(name, "auto")
    x = torch.from_numpy(ref["x"])
    raw = wl.engine.engine.cross_check(x)             # graph == flat oracle
    np.testing.assert_allclose(raw.numpy(), ref["raw"], rtol=0,
                               atol=FLOAT_ATOL)
    rows = wl.engine.engine.backend_choices
    assert rows and all(r["backend"] in PLAIN and r["tile"] == {}
                        for r in rows)


def test_unknown_mode_still_raises():
    wl = port_workload("alexnet_imagenet", "no_such_mode")
    with pytest.raises(ValueError, match="unusable"):
        wl.engine.engine.compile(1)


# --------------------------------------------------------------------------
# The same outcomes as the reference's tuner
# --------------------------------------------------------------------------

def _stub_time(self, node, x, backend, tile):
    """One fixed table for both sides: a pseudo-random time by (op, output
    channels, kernel, the backend's JAX name)."""
    key = repr((node.op, node.attrs.get("channels"),
                node.attrs.get("kernel"), JAX_MODE.get(backend, backend)))
    return zlib.crc32(key.encode()) / 2 ** 32


def _stub_chain(self, chain, arrays, x, tile):
    return zlib.crc32(repr(sorted(tile.items())).encode()) / 2 ** 32


def _outcomes(events) -> list[str]:
    return [e["outcome"] for e in events]


def _run_sequence(mk_tuner, use_registry, graph, shape_of, restamp):
    """miss (bucket 8), hit (8 again), xfer_hit (bucket 1), then a second
    tuner: disk_hit (8), xfer_hit (1); then a stamp change: disk_miss +
    miss (8).  Returns (outcomes a step, winners a step)."""
    steps, winners = [], []
    with use_registry() as reg:
        a = mk_tuner()
        for tuner, bucket in ((a, 8), (a, 8), (a, 1)):
            n = len(reg.events())
            winners.append(tuner.tune(graph, shape_of(bucket)))
            steps.append(_outcomes(reg.events()[n:]))
        b = mk_tuner()
        for bucket in (8, 1):
            n = len(reg.events())
            winners.append(b.tune(graph, shape_of(bucket)))
            steps.append(_outcomes(reg.events()[n:]))
        restamp()
        c = mk_tuner()
        n = len(reg.events())
        winners.append(c.tune(graph, shape_of(8)))
        steps.append(_outcomes(reg.events()[n:]))
    return steps, winners


@pytest.mark.parametrize("name", NAMES)
def test_outcome_sequence_matches_reference(name, monkeypatch, tmp_path):
    eng, j_eng, _ = both_graphs(name)
    monkeypatch.setattr(autotune.Autotuner, "_time_node", _stub_time)
    monkeypatch.setattr(j_autotune.Autotuner, "_time_node", _stub_time)

    def run(side):
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                           str(tmp_path / f"{side}.json"))
        if side == "port":
            return _run_sequence(
                lambda: autotune.Autotuner(candidates=PLAIN, device="cpu"),
                metrics.use_registry, eng._graph, eng._plan_shape,
                lambda: monkeypatch.setattr(
                    autotune, "env_stamp",
                    lambda device: {"torch": "another"}))
        return _run_sequence(
            lambda: j_autotune.Autotuner(candidates=("xla", "xla_pm1")),
            j_metrics.use_registry, j_eng._graph, j_eng._plan_shape,
            lambda: monkeypatch.setattr(j_autotune, "_env_stamp",
                                        lambda: {"jax": "another"}))

    got_steps, got_win = run("port")
    want_steps, want_win = run("jax")
    assert got_steps == want_steps
    n = len(got_win[0])
    assert got_steps[0] == ["miss"] * n and got_steps[1] == ["hit"] * n
    assert got_steps[2] == ["xfer_hit"] * n
    assert got_steps[3] == ["disk_hit"] * n
    assert got_steps[4] == ["xfer_hit"] * n
    assert got_steps[5] == ["disk_miss", "miss"] * n
    for got, want in zip(got_win, want_win):
        assert {nid: JAX_MODE[b] for nid, b in got.items()} == want


def test_chain_outcomes_match_reference(monkeypatch, tmp_path):
    eng, j_eng, _ = both_graphs("alexnet_imagenet")
    shape = eng._plan_shape(2)
    chains = regions.partition_chains(eng._graph, shape)
    j_chains = j_runtime.partition_chains(j_eng._graph, shape)
    assert [c.node_ids for c in chains] == [c.node_ids for c in j_chains]
    monkeypatch.setattr(autotune.Autotuner, "_time_chain", _stub_chain)
    monkeypatch.setattr(j_autotune.Autotuner, "_time_chain", _stub_chain)
    seen = []
    for side, mod, reg_of, graph, cs in (
            ("port", autotune, metrics, eng._graph, chains),
            ("jax", j_autotune, j_metrics, j_eng._graph, j_chains)):
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                           str(tmp_path / f"{side}.json"))
        kw = dict(device="cpu") if side == "port" else {}
        with reg_of.use_registry() as reg:
            mod.Autotuner(**kw).tune_chains(graph, cs)
            mod.Autotuner(**kw).tune_chains(graph, cs)
            seen.append((_outcomes(reg.events()), [c.tile for c in cs]))
    assert seen[0] == seen[1]
    assert seen[0][0] == ["miss"] * len(chains) + ["disk_hit"] * len(chains)


def test_jax_stamped_entry_is_a_disk_miss(cache_file, monkeypatch):
    eng = port_workload("alexnet_imagenet").engine.engine
    shape = eng._plan_shape(1)
    monkeypatch.setattr(autotune.Autotuner, "_time_node", _stub_time)
    autotune.Autotuner(candidates=PLAIN, device="cpu").tune(eng._graph,
                                                            shape)
    disk = json.loads(cache_file.read_text())
    assert all(e["env"] == autotune.env_stamp("cpu") for e in disk.values())
    assert set(autotune.env_stamp("cpu")) == {"torch", "cuda", "device"}
    for e in disk.values():
        e["env"] = {"jax": jax.__version__, "jaxlib": None}
    cache_file.write_text(json.dumps(disk))
    with metrics.use_registry() as reg:
        autotune.Autotuner(candidates=PLAIN, device="cpu").tune(eng._graph,
                                                                shape)
        counts = reg.snapshot()
    assert counts["autotune.disk_miss"] == counts["autotune.miss"] > 0
    assert "autotune.disk_hit" not in counts


def test_persistence_off(monkeypatch, cache_file):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "0")
    assert autotune.cache_path() is None
    eng = port_workload("alexnet_imagenet").engine.engine
    monkeypatch.setattr(autotune.Autotuner, "_time_node", _stub_time)
    autotune.Autotuner(candidates=PLAIN, device="cpu").tune(
        eng._graph, eng._plan_shape(1))
    assert not cache_file.exists()
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert str(autotune.cache_path()).endswith(
        "repro_torch/autotune.json")


def test_sweep_events_and_spans(monkeypatch):
    from repro_torch.obs import trace

    eng = port_workload("alexnet_imagenet").engine.engine
    tracer = trace.install()
    try:
        with metrics.use_registry() as reg:
            autotune.Autotuner(candidates=PLAIN, device="cpu", warmup=0,
                               iters=1).tune(eng._graph, eng._plan_shape(1))
    finally:
        trace.uninstall()
    misses = reg.events("autotune")
    assert misses and all(e["outcome"] == "miss" and e["sweep_size"] == 2
                          for e in misses)
    assert len(tracer.spans("autotune.sweep")) == len(misses)


# --------------------------------------------------------------------------
# K3 tiles
# --------------------------------------------------------------------------

def paper_alexnet():
    wl = t_workloads.get("alexnet_imagenet", device="cpu", seed=0)
    return wl.engine.engine


@pytest.mark.parametrize("backend", ["cuda_direct", "cuda_direct_pool"])
def test_tile_candidates_follow_the_planner(backend):
    eng = paper_alexnet()
    g = eng._graph
    types = infer_types(g, eng._plan_shape(8))
    convs = [n for n in g.nodes.values()
             if backend in executor.valid_backends(n.op)]
    assert convs
    for node in convs:
        shape = types[node.inputs[0]].shape
        cands = autotune.tile_candidates(backend, node, shape, H100)
        call = autotune._k3_call(backend, node, shape)
        args, geo = call
        pick = k3.plan_mma(*args, **geo, limits=H100)
        every = {(p.tile_h, p.tile_w, p.nw_block)
                 for _, p in k3.mma_candidates(*args, **geo, limits=H100)}
        tiles = [(t["tile_h"], t["tile_w"], t["nw_block"]) for t in cands]
        assert tiles[0] == (pick.tile_h, pick.tile_w, pick.nw_block)
        assert len(set(tiles)) == len(tiles) == min(4, len(every))
        assert set(tiles) <= every
        assert geo["planes"] == bool(node.attrs.get("first"))
    # Backends with their own planners, and no card: no per-node tile.
    assert autotune.tile_candidates("cuda_pm1", convs[0], shape, H100) \
        == [{}]
    assert autotune.tile_candidates(backend, convs[0], shape, None) == [{}]


def test_forced_tile_reaches_eval_node_and_report(monkeypatch):
    ref = reference("alexnet_imagenet")
    eng = port_workload("alexnet_imagenet").engine.engine
    x = torch.from_numpy(ref["x"])
    g = eng._graph
    conv = next(nid for nid, n in g.nodes.items()
                if n.op == "packed_conv_pool")
    tile = {"tile_h": 3, "tile_w": 2, "nw_block": 1}
    exe = GraphExecutor(g, "cuda_direct_pool", tiles={conv: tile})
    seen = {}
    real = executor.eval_node

    def spy(op, attrs, params, inputs, backend="torch", tile=None):
        seen.setdefault(backend, []).append(tile)
        return real(op, attrs, params, inputs, backend=backend, tile=tile)
    monkeypatch.setattr(executor, "eval_node", spy)
    got = exe(x)
    assert tile in seen["cuda_direct_pool"]
    row = next(r for r in exe.backend_report() if r["node"] == conv)
    assert row["tile"] == tile and row["backend"] == "cuda_direct_pool"
    plain = GraphExecutor(g, "cuda_direct_pool")(x)
    assert torch.equal(got, plain)                 # a tile changes nothing
    np.testing.assert_allclose(got.numpy(), ref["raw"], rtol=0,
                               atol=FLOAT_ATOL)
    with pytest.raises(ValueError, match="takes no tile"):
        GraphExecutor(g, "cuda_pm1", tiles={conv: tile})


def test_cuda_candidates_hold_no_plain_backend():
    on_card = autotune.default_candidates("cuda")
    assert on_card and not set(on_card) & set(autotune.PLAIN_BACKENDS)
    assert set(on_card) == {"cuda_pm1", "cuda_popcount", "cuda_direct",
                            "cuda_direct_pool"}
    assert autotune.default_candidates(torch.device("cuda", 0)) == on_card
    assert autotune.default_candidates("cpu") == PLAIN
    with pytest.raises(ValueError, match="unknown candidate"):
        autotune.Autotuner(candidates=("xla",), device="cpu")


# --------------------------------------------------------------------------
# Chains
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_chain_executor_with_tuner_matches_reference(name):
    ref = reference(name)
    eng = port_workload(name).engine.engine
    x = torch.from_numpy(ref["x"])
    tuner = autotune.Autotuner(device="cpu", warmup=0, iters=1)
    with metrics.use_registry() as reg:
        exe = regions.chain_executor(eng._graph, tuple(x.shape),
                                     tuner=tuner)
    assert exe.regions and reg.counter("autotune.miss").value \
        == len(exe.regions)
    for chain in exe.regions:
        entry = tuner.chain_entry(chain)
        assert chain.tile == entry["tile"]
        assert len(entry["timings_ms"]) \
            == len(autotune.chain_tile_candidates(chain)) >= 2
    np.testing.assert_allclose(exe(x).numpy(), ref["raw"], rtol=0,
                               atol=FLOAT_ATOL)
    tail = regions.chain_executor(tail_graph(eng._graph), tuple(x.shape),
                                  tuner=tuner)
    np.testing.assert_array_equal(tail(x).numpy(), ref["packed_tail"])


def test_chain_tile_candidates_fit_the_budget():
    """AlexNet's region at batch 2: two images a block fit the card's
    227 KB; at a budget of one image's whole-map arena they do not, and
    the sweep drops that tile."""
    eng = paper_alexnet()
    shape = eng._plan_shape(2)
    (chain,) = regions.partition_chains(eng._graph, shape)
    cands = autotune.chain_tile_candidates(chain)
    assert cands[0] == {} and {"block_n": 2} in cands
    assert {"block_h": 4} in cands
    for t in cands:
        assert regions.plan_chain_vmem(chain.stages, chain.in_shape,
                                       tile=t,
                                       budget=chain.plan.budget).fits()
    tight = regions.build_chain(eng._graph, chain.node_ids, shape,
                                budget=chain.plan.arena_bytes)
    tight_cands = autotune.chain_tile_candidates(tight)
    assert {} in tight_cands and {"block_h": 4} in tight_cands
    assert {"block_n": 2} not in tight_cands
