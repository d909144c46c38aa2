"""Port parity: the placement pass and the placed servers
(``repro_torch.runtime.placement``, ``repro_torch.distributed``) against
``repro.runtime.placement`` and the reference's servers, in-process on
the CPU with one device listed k times (``[torch.device("cpu")] * k``
beside ``[jax.devices()[0]] * k``, as ``tests/test_distributed.py`` runs
the reference; no forced mesh).

* **Plans** — ``cut_candidates``, ``plan_pipeline`` (stages, boundaries,
  costs) and each stage's subgraph equal the reference's on the reference
  test's two tiny nets and the three tiny workloads, for k in 1..4 and
  for k = 99 (fewer legal cuts: the plan degrades the same way).
* **Staged executor** — under every port mode the k-stage forward equals
  the port's single-device forward bit for bit and its per-node backends
  and regions, listed over the stages, are the single-device executor's
  (so the stages launch the same kernels on the card); it equals the JAX
  ``StagedExecutor`` over k listed devices in mode ``xla`` (packed words
  exact, float heads within ``tests/harness.py``'s 1e-4).  Under
  ``cuda_chain`` no cut falls inside a port region.
* **Servers** — pipelined, data-parallel over ``[cpu, cpu]`` and
  synchronous servers serve a workload's decoded rows equal to the
  single-device server's, and the bare engine's rows equal to the JAX
  ``xla`` engine's; data-parallel buckets round up as the reference's do; ``metrics()``'s ``placement``, ``async_dispatch`` and
  ``data_parallel`` equal the reference's; sync equals async.
* **Engine** — a placed bucket's key extends the plain one (both cached
  side by side), pipeline and data parallelism are exclusive, an engine
  view shares the packed tensors and owns its caches; ``Pipelined.over``
  and ``DataParallel.over`` default to the cards, never the CPU.
* **CLI** — ``--sync`` serves the blocking baseline; ``--shard`` on a host
  without two cards serves unsharded.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro import runtime as j_runtime
from repro.workloads import workload as j_workload
from repro.core import bnn_model as j_bnn
from repro.core import layer_integration as j_li
from repro.distributed import Pipelined as JPipelined
from repro.serving import InferenceServer as JServer
from repro.serving import PhoneBitEngine as JEngine
from repro_torch import runtime as t_runtime
from repro_torch import workloads as t_workloads
from repro_torch.core import layer_integration as t_li
from repro_torch.core.bnn_model import BConv, BDense, FloatDense, Pool
from repro_torch.distributed import DataParallel, Pipelined
from repro_torch.launch import serve as cli
from repro_torch.runtime.placement import chain_interiors
from repro_torch.serving import InferenceServer, PhoneBitEngine

CPU = torch.device("cpu")
FLOAT_ATOL = 1e-4
WORKLOADS = ("alexnet_imagenet", "vgg16_imagenet", "yolov2_tiny_voc")
NETS = ("float", "packed") + WORKLOADS
# The reference's tiny specs (the port's are equal layer for layer).
J_TINY = {"alexnet_imagenet": lambda: j_workload._tiny_alexnet()[0],
          "vgg16_imagenet": lambda: j_workload._tiny_vgg16()[0],
          "yolov2_tiny_voc": lambda: j_workload._tiny_yolov2(
              j_workload.DetectConfig())[0]}
PORT_MODES = ("torch", "torch_pm1", "cuda_pm1", "cuda_popcount",
              "cuda_direct", "cuda_direct_pool", "cuda_chain", "auto")


class _Port:
    BConv, BDense, FloatDense, Pool = BConv, BDense, FloatDense, Pool


def _tiny_spec(mod, tail: str):
    """The reference test's two tiny nets (``tests/test_distributed.py``)."""
    if tail == "float":
        return [mod.BConv(3, 32, kernel=3, stride=1, pad=1, first=True),
                mod.Pool(2, 2), mod.FloatDense(8 * 8 * 32, 10)]
    return [mod.BConv(3, 32, kernel=3, stride=1, pad=1, first=True),
            mod.BConv(32, 32, kernel=3, stride=1, pad=1),
            mod.Pool(2, 2), mod.BDense(8 * 8 * 32, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny shapes here run faster on one intra-op thread than on a
    pool the suite's parallel workers all share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """name -> (the port's engine on the CPU in mode ``torch``, the JAX
    engine in ``xla``, the batch-2 input shape), built once.  The two
    reference nets come from JAX params, converted by each package; a
    workload's JAX engine serves the port converter's packed arrays (the
    converters are held equal in ``test_torch_convert.py``), which spares
    the JAX package's slow eager conversion."""
    out = {}
    for tail in ("float", "packed"):
        jp = j_bnn.init_params(jax.random.key(0), _tiny_spec(j_bnn, tail))
        port = PhoneBitEngine.from_trained(
            [{k: np.asarray(v) for k, v in p.items()} for p in jp],
            _tiny_spec(_Port, tail), (16, 16), matmul_mode="torch",
            device="cpu")
        out[tail] = dict(port=port, jax=JEngine.from_trained(
            jp, _tiny_spec(j_bnn, tail), (16, 16)), shape=(2, 16, 16, 3))
    for name in WORKLOADS:
        twl = t_workloads.get(name, variant="tiny", device="cpu",
                              matmul_mode="torch")
        eng = twl.engine.engine
        packed = [{k: _as_jax(v) for k, v in layer.items()}
                  for layer in eng.packed]
        h, w = twl.input_hw
        out[name] = dict(port=eng, jax=JEngine(
            spec=J_TINY[name](), packed=packed, input_hw=(h, w)),
            shape=(2, h, w, 3), twl=twl)
    return out


def _as_jax(v):
    """A port artifact value as the JAX package takes it."""
    if isinstance(v, t_li.IntegratedParams):
        return j_li.IntegratedParams(*(f.numpy() for f in v))
    return v.numpy() if torch.is_tensor(v) else v


def _port_engine(net: dict, mode: str) -> PhoneBitEngine:
    base = net["port"]
    return PhoneBitEngine(spec=base.spec, packed=base.packed,
                          input_hw=base.input_hw, matmul_mode=mode,
                          device="cpu")


def _input(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _close(got, want) -> None:
    """Packed words exactly, float outputs within the harness's 1e-4."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)


def _subgraph_view(g) -> dict:
    return dict(input_id=g.input_id, output_id=g.output_id,
                nodes={nid: (n.op, tuple(n.inputs))
                       for nid, n in g.nodes.items()})


# --------------------------------------------------------------------------
# Plans against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NETS)
def test_plans_as_reference(nets, name):
    """Cut candidates, plans for k in 1..4 and 99, and every stage's
    subgraph equal the reference's on the same graph."""
    net = nets[name]
    tg, jg = net["port"]._graph, net["jax"]._graph
    assert t_runtime.cut_candidates(tg) == j_runtime.cut_candidates(jg)
    for k in (1, 2, 3, 4, 99):
        tp = t_runtime.plan_pipeline(tg, net["shape"], k)
        jp = j_runtime.plan_pipeline(jg, net["shape"], k)
        assert (tp.stages, tp.boundaries, tp.costs) == \
            (jp.stages, jp.boundaries, jp.costs)
        assert tp.report() == jp.report()
        for i, ids in enumerate(tp.stages):
            b = tp.boundaries[i - 1] if i else None
            assert _subgraph_view(t_runtime.stage_subgraph(tg, ids, b)) == \
                _subgraph_view(j_runtime.stage_subgraph(jg, ids, b))
    assert t_runtime.plan_pipeline(tg, net["shape"], 99).n_stages == \
        len(t_runtime.cut_candidates(tg)) + 1


def test_plan_refuses_zero_stages(nets):
    with pytest.raises(ValueError):
        t_runtime.plan_pipeline(nets["float"]["port"]._graph,
                                (1, 16, 16, 3), 0)


# --------------------------------------------------------------------------
# The staged executor
# --------------------------------------------------------------------------

def _rows(report) -> list[dict]:
    return [{k: v for k, v in r.items() if k not in ("stage", "device")}
            for r in report]


@pytest.mark.parametrize("mode", PORT_MODES)
@pytest.mark.parametrize("name", NETS)
def test_staged_forward_equals_single(nets, name, mode):
    """k stages over k listed CPUs: the single-device forward bit for bit,
    the same per-node backends and regions, params shared with the
    engine (``.to`` of a tensor already there).  Under ``"auto"`` each
    stage is tuned on its own subgraph, whose boundary placeholder keeps
    the boundary's dtype, and takes the single-device winners (the same
    node signatures)."""
    net = nets[name]
    eng = _port_engine(net, mode)
    x = torch.as_tensor(_input(net["shape"]))
    single = eng.compile(net["shape"][0], capture=False)
    ref = single(x)
    tuner = eng._tuner_for if mode == "auto" else None
    for k in (1, 2, 3, 4):
        exe = t_runtime.staged_executor(eng._graph, net["shape"], [CPU] * k,
                                        mode=mode, tuner=tuner)
        assert torch.equal(exe(x), ref)
        assert _rows(exe.backend_report()) == single.backend_report()
        assert len(exe.stage_report()) == exe.plan.n_stages
        # Each stage's subgraph types its boundary placeholder as the
        # boundary (packed words or floats), not as an image.
        full = t_runtime.infer_types(eng._graph, net["shape"])
        for stage, (shape, dtype) in zip(exe.stage_executors,
                                         exe.stage_inputs):
            sub = stage.graph
            assert t_runtime.infer_types(sub, shape)[sub.input_id] == \
                full[sub.input_id] == t_runtime.TensorType(shape, dtype)
        for stage in exe.stage_executors:
            for nid, node in stage.graph.nodes.items():
                for key, v in node.params.items():
                    if torch.is_tensor(v):
                        assert v is eng._graph.nodes[nid].params[key]


@pytest.mark.parametrize("name", NETS)
def test_staged_forward_as_reference(nets, name):
    """The port's k-stage forward against the JAX ``StagedExecutor`` over
    k listed devices (k in {2, 3}; k = 1 is the plain forward the other
    parity files hold), both on the same graph and input."""
    net = nets[name]
    x = _input(net["shape"], seed=1)
    dev = jax.devices()[0]
    for k in (2, 3):
        got = t_runtime.staged_executor(net["port"]._graph, net["shape"],
                                        [CPU] * k)(torch.as_tensor(x))
        want = j_runtime.staged_executor(net["jax"]._graph, net["shape"],
                                         (dev,) * k, mode="xla")(x)
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", NETS)
def test_chain_mode_cuts_between_regions(nets, name):
    """Under ``cuda_chain`` no boundary and no stage's first node lies
    inside a port region, the regions over the stages are the
    single-device executor's, and the output is bit-exact."""
    net = nets[name]
    eng = _port_engine(net, "cuda_chain")
    g, shape = eng._graph, net["shape"]
    forbidden = chain_interiors(t_runtime.partition_chains(g, shape))
    x = torch.as_tensor(_input(shape, seed=2))
    single = eng.compile(shape[0], capture=False)
    for k in (2, 3, 4):
        exe = t_runtime.StagedExecutor(g, shape, [CPU] * k,
                                       mode="cuda_chain")
        for b, stage in zip(exe.plan.boundaries, exe.plan.stages[1:]):
            assert b not in forbidden and stage[0] not in forbidden
        assert [c.node_ids for c in exe.regions] == \
            [c.node_ids for c in single.regions]
        assert torch.equal(exe(x), single(x))


# --------------------------------------------------------------------------
# Placed and synchronous servers
# --------------------------------------------------------------------------

def _serve(server, imgs) -> list:
    reqs = [server.submit(i) for i in imgs]
    server.drain()
    assert all(r.outcome == "served" for r in reqs)
    return [r.result for r in reqs]


PLACED = {"pipelined": dict(placement=Pipelined([CPU] * 3)),
          "data": dict(placement=DataParallel([CPU] * 2)),
          "sync": dict(async_dispatch=False)}


@pytest.mark.parametrize("mode", ["torch", "cuda_chain", "cuda_pm1"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_placed_servers_serve_single_device_rows(nets, name, mode):
    """Pipelined, data-parallel and synchronous servers: a tiny workload's
    decoded rows (images of another size through its preprocess hook)
    equal the single-device server's bit for bit, and the network's raw
    rows served by the bare engine equal the JAX ``xla`` engine's (packed
    words exact, float outputs within 1e-4)."""
    net = nets[name]
    twl = t_workloads.get(name, variant="tiny", device="cpu",
                          matmul_mode=mode, params=net["twl"].params)
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
            for _ in range(7)]
    frames = [rng.integers(0, 256, net["shape"][1:], dtype=np.uint8)
              for _ in range(7)]
    kw = dict(buckets=(1, 2, 4), max_batch=4)
    want = _serve(twl.server(**kw), imgs)
    jax_raw = np.asarray(net["jax"](np.stack(frames)))
    for placed in PLACED.values():
        got = _serve(twl.server(**kw, **placed), imgs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        raw = _serve(InferenceServer(twl.engine.engine, **kw, **placed),
                     frames)
        for g, j in zip(raw, jax_raw):
            _close(g, j)


def _jax_data_placement(n: int):
    """A stand-in for the reference's ``DataParallel`` over an n-device
    mesh: its server reads only ``kind``, ``mesh.shape`` and ``axis`` when
    it is built (one process has one CPU device)."""
    return types.SimpleNamespace(kind="data", axis="data",
                                 mesh=types.SimpleNamespace(
                                     shape={"data": n}))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_data_parallel_buckets_and_metrics_as_reference(nets, n):
    net = nets["packed"]
    kw = dict(buckets=(1, 2, 4, 8), max_batch=2)
    port = InferenceServer(net["port"], placement=DataParallel([CPU] * n),
                           **kw)
    ref = JServer(net["jax"], placement=_jax_data_placement(n), **kw)
    assert port.scheduler.buckets == ref.scheduler.buckets
    assert port.scheduler.max_batch == ref.scheduler.max_batch
    pm, rm = port.metrics(), ref.metrics()
    for key in ("placement", "async_dispatch", "data_parallel"):
        assert pm[key] == rm[key]


def test_pipeline_and_sync_metrics_as_reference(nets):
    net = nets["packed"]
    dev = jax.devices()[0]
    for async_dispatch in (True, False):
        port = InferenceServer(net["port"], placement=Pipelined([CPU] * 2),
                               async_dispatch=async_dispatch)
        ref = JServer(net["jax"], placement=JPipelined((dev, dev)),
                      async_dispatch=async_dispatch)
        pm, rm = port.metrics(), ref.metrics()
        assert pm["async_dispatch"] == rm["async_dispatch"] == \
            async_dispatch
        assert pm["data_parallel"] == rm["data_parallel"] == 1
        assert pm["placement"]["kind"] == rm["placement"]["kind"]
        assert pm["placement"]["devices"] == ["cpu", "cpu"]
        assert len(rm["placement"]["devices"]) == 2
    plain = InferenceServer(net["port"]).metrics()
    assert "placement" not in plain and plain["data_parallel"] == 1
    with pytest.raises(ValueError, match="kind"):
        InferenceServer(net["port"], placement=object())
    with pytest.raises(ValueError, match="artifact"):
        InferenceServer(net["port"], placement=Pipelined([CPU]),
                        artifact="unused")


def test_async_matches_sync_as_reference(nets):
    """Nine images through buckets (1, 2, 4) async and sync, on the port
    and the reference: the same rows; a sync step scatters the batch it
    dispatched, so nothing is left pending."""
    net = nets["float"]
    imgs = [_input((16, 16, 3), seed=10 + i) for i in range(9)]
    outs = {}
    for side, eng, cls in (("port", net["port"], InferenceServer),
                           ("jax", net["jax"], JServer)):
        for mode in (True, False):
            server = cls(eng, buckets=(1, 2, 4), max_batch=4,
                         async_dispatch=mode)
            reqs = [server.submit(i) for i in imgs]
            if not mode:
                done = server.step(force=True)
                assert len(done) == 4 and server._pending is None
            server.drain()
            assert all(r.done and r.outcome == "served" for r in reqs)
            outs[side, mode] = [np.asarray(r.result) for r in reqs]
    for a, b in zip(outs["port", True], outs["port", False]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(outs["port", False], outs["jax", False]):
        _close(a, b)


# --------------------------------------------------------------------------
# The engine's placed buckets and views
# --------------------------------------------------------------------------

def test_placed_keys_extend_the_bucket_key(nets):
    eng = _port_engine(nets["packed"], "torch")
    plain = eng.compile(2, capture=False)
    staged = eng.compile(2, pipeline=[CPU, CPU], capture=False)
    sharded = eng.compile(2, data_parallel=[CPU, CPU], capture=False)
    assert isinstance(staged, t_runtime.StagedExecutor)
    assert isinstance(sharded, t_runtime.ShardedExecutor)
    assert plain is eng.compile(2, capture=False)
    assert staged is eng.compile(2, pipeline=("cpu", "cpu"), capture=False)
    assert sorted(map(len, eng._compiled)) == [2, 3, 4]
    assert eng.build_count == 3
    with pytest.raises(ValueError, match="exclusive"):
        eng.compile(2, pipeline=[CPU], data_parallel=[CPU])
    with pytest.raises(ValueError, match="divisible"):
        eng.compile(3, data_parallel=[CPU, CPU])
    with pytest.raises(ValueError, match="capture"):
        eng.compile(2, pipeline=[CPU], capture=True)


def test_engine_view_shares_params_owns_caches(nets):
    eng = _port_engine(nets["packed"], "torch")
    eng.compile(1, capture=False)
    view = eng.view()
    assert view is not eng and view._compiled == {} and \
        view._captured == {}
    for a, b in zip(eng.packed, view.packed):
        for k, v in a.items():
            if torch.is_tensor(v):
                assert b[k] is v
    wl = nets["alexnet_imagenet"]["twl"]
    wview = wl.engine.view()
    assert wview.head is wl.engine.head
    assert wview.engine is not wl.engine.engine


def test_over_defaults_to_the_cards():
    """``over`` takes the visible cards (none here), never the CPU."""
    for cls in (Pipelined, DataParallel):
        if not torch.cuda.is_available():
            with pytest.raises(ValueError, match="visible"):
                cls.over(1)
        assert cls.over(2, [CPU] * 3).devices == (CPU, CPU)
        with pytest.raises(ValueError):
            cls.over(4, [CPU] * 3)
        with pytest.raises(ValueError):
            cls(())
    assert Pipelined([CPU]).kind == "pipeline" and \
        DataParallel([CPU]).kind == "data"


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--sync", "--shard"])
def test_cli_sync_and_shard(flag, capsys):
    m = cli.main(["--device", "cpu", "--workload", "alexnet_imagenet",
                  "--variant", "tiny", "--requests", "4", "--batch", "2",
                  flag])
    out = capsys.readouterr().out
    assert m["served"] == 4
    if flag == "--sync":
        assert m["async_dispatch"] is False and "sync" in out
    else:
        assert m["async_dispatch"] is True and "placement" not in m
        assert "unsharded" in out
