"""Port parity: the servers' resilience layer (``tests/test_resilience.py``
and the per-bucket cases of ``tests/test_recovery.py`` on the port).

* **Fault matrix** — for each site x kind of the reference's
  ``TestFaultMatrix`` and each retry policy, the port's
  ``InferenceServer`` under ``torch_pm1`` and the JAX one under
  ``xla_pm1`` run one plan under one fake clock: the same outcomes,
  attempts, retries, errors, fault log (modes through ``JAX_MODE``,
  request ids as submission order) and clock, and served rows equal
  within the float head's 1e-4 (each port row also equal to
  ``cross_check``).  The JAX side stays on ``xla``/``xla_pm1``: its
  ``vpu_*`` modes raise under the installed jax.
* **Admission** — bad payloads and a full queue resolve ``rejected``;
  a payload whose preprocess leaves it the wrong shape resolves
  ``error`` at staging, alone.
* **Degradation** — ``torch_pm1`` demotes to ``torch`` after consecutive
  failures, as the reference's ``xla_pm1`` to ``xla``, re-probes and
  promotes; one bucket demotes alone; on the port's own ladder
  ``cuda_chain`` (K5's plain version here) demotes to
  ``cuda_direct_pool``, whose executor is built at that bucket's next
  dispatch, serves rows equal to ``cross_check``, and a probe promotes
  the bucket back; a server over an engine on the card ends its ladder
  at ``cuda_popcount`` and resolves ``error`` there, never reaching a
  plain PyTorch rung.
* **Watchdog and drain** — the watchdog times out a wedged readback, no
  thread runs without it, drain is bounded when every dispatch faults,
  and ``max_steps=0`` aborts.
* **Multiplexer** — degradation stays in its tenant's lane
  (``torch_pm1`` to ``torch``), and the arbiter sleeps through ``sleep=``
  when every lane is starved by backoff.
* **Executor** — ``GraphExecutor.traced_call`` equals ``__call__`` bit
  for bit with one span a node, the reference's span names and shapes on
  the same graph, and a ``region.*`` span a K5 region.
* **CLI** — ``python -m repro_torch.launch.serve --device cpu
  --fault-storm`` prints its resilience line; in-process, an artifact
  export then a journaled boot from it with a trace, a multi-tenant run
  and the LM demo.
"""

import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import bnn_model as j_bnn
from repro.serving import InferenceServer as JServer
from repro.serving import PhoneBitEngine as JEngine
from repro.obs import trace as j_trace
from repro.serving import faults as j_faults
from repro_torch import workloads
from repro_torch.core.bnn_model import BConv, FloatDense, Pool
from repro_torch.kernels.ops import JAX_MODE
from repro_torch.launch import serve as cli
from repro_torch.obs import trace
from repro_torch.serving import (InferenceServer, MultiTenantServer,
                                 PhoneBitEngine, faults)
from repro_torch.serving.faults import FaultPlan, FaultSpec, RetryPolicy
from repro_torch.serving.scheduler import OUTCOMES

HW = (16, 16)
FLOAT_ATOL = 1e-4


class _Port:
    BConv, Pool, FloatDense = BConv, Pool, FloatDense


def _spec(mod, c: int = 32):
    return [mod.BConv(3, c, kernel=3, stride=1, pad=1, first=True),
            mod.Pool(2, 2), mod.FloatDense(8 * 8 * c, 10)]


@pytest.fixture(scope="module")
def engines():
    """(the port's torch engine, the reference's xla engine) on the same
    params, crossed as numpy."""
    jp = j_bnn.init_params(jax.random.key(0), _spec(j_bnn))
    port = PhoneBitEngine.from_trained(
        [{k: np.asarray(v) for k, v in p.items()} for p in jp],
        _spec(_Port), HW, matmul_mode="torch", device="cpu")
    return port, JEngine.from_trained(jp, _spec(j_bnn), HW)


def _port_engine(engines, mode: str) -> PhoneBitEngine:
    base = engines[0]
    return PhoneBitEngine(spec=base.spec, packed=base.packed,
                          input_hw=base.input_hw, matmul_mode=mode,
                          device="cpu")


def _jax_engine(engines, mode: str) -> JEngine:
    base = engines[1]
    return JEngine(spec=base.spec, packed=base.packed,
                   input_hw=base.input_hw, matmul_mode=mode)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
            for _ in range(n)]


class FakeClock:
    """Monotonic fake clock; ``sleep`` advances it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += max(s, 0.0)


def _server(engine, cls=InferenceServer, clock=None, **kw):
    clock = clock or FakeClock()
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_s", 0.0)
    return cls(engine, clock=clock, sleep=clock.sleep, **kw), clock


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    faults.uninstall()
    j_faults.uninstall()

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny shapes here run several times faster on one intra-op
    thread than on a pool the suite's parallel workers all share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=0, atol=FLOAT_ATOL)


# --------------------------------------------------------------------------
# The fault matrix against the reference
# --------------------------------------------------------------------------

MATRIX_SITES = [
    ("server.preprocess", "preprocess_error"),
    ("server.dispatch", "device_oom"),
    ("server.device", "device_fault"),
    ("engine.compile", "compile_error"),
    ("executor.call", "device_oom"),
]
MATRIX_RETRY = {
    "no-retry": None,
    "one-shot": dict(max_attempts=1, jitter=0.0),
    "retry3": dict(max_attempts=3, backoff_base_s=0.01, jitter=0.0),
}


def _serve_under_plan(side, engines, specs, retry, n=6, seed=0, **kw):
    """Serve ``n`` images through a fresh engine of ``side`` ("port" under
    torch_pm1, "jax" under xla_pm1) with ``specs`` installed; returns the
    server, its requests, the plan and the clock."""
    if side == "port":
        eng, cls, mod = _port_engine(engines, "torch_pm1"), InferenceServer, \
            faults
    else:
        eng, cls, mod = _jax_engine(engines, "xla_pm1"), JServer, j_faults
    policy = None if retry is None else mod.RetryPolicy(**retry)
    server, clock = _server(eng, cls, retry=policy, **kw)
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=seed,
                         sleep=clock.sleep)
    mod.install(plan)
    try:
        rs = [server.submit(p) for p in _images(n)]
        server.drain()
    finally:
        mod.uninstall()
    return server, rs, plan, clock


def _summary(server, rs, plan, clock):
    """What both packages must agree on, in the reference's names."""
    index = {r.id: i for i, r in enumerate(rs)}
    log = []
    for f in plan.log:
        f = {k: JAX_MODE.get(v, v) if k == "mode" else v
             for k, v in f.items()}
        if "req" in f:
            f["req"] = index[f["req"]]
        if "nodes" in f:
            f["nodes"] = "n"          # compared below, graph sizes apart
        log.append(f)
    m = server.metrics()
    return dict(outcomes=[r.outcome for r in rs],
                attempts=[r.attempts for r in rs],
                counters={k: m[k] for k in ("served", "retries", "errors",
                                            "rejected", "degraded")},
                mode=JAX_MODE.get(m["mode"], m["mode"]),
                log=log, clock=clock.t,
                flight=[f.get("outcome") for f in server.flight.dump()])


@pytest.mark.parametrize("retry", list(MATRIX_RETRY))
@pytest.mark.parametrize("site,kind", MATRIX_SITES,
                         ids=[s for s, _ in MATRIX_SITES])
def test_fault_matrix_as_reference(engines, site, kind, retry):
    """One fault at ``site``: the same terminal outcomes, attempts,
    counters, fault log, clock and flight outcomes in both packages, and
    the same served rows; each port row equals ``cross_check``."""
    specs = [dict(site=site, kind=kind, times=1)]
    kw = dict(buckets=(1,), max_batch=1)
    got = _serve_under_plan("port", engines, specs, MATRIX_RETRY[retry],
                            **kw)
    want = _serve_under_plan("jax", engines, specs, MATRIX_RETRY[retry],
                             **kw)
    assert _summary(*got) == _summary(*want)
    server, rs, plan, _ = got
    assert len(plan.log) == 1 and all(r.outcome in OUTCOMES for r in rs)
    budget = MATRIX_RETRY[retry]["max_attempts"] if MATRIX_RETRY[retry] \
        else 1
    if budget > 1:
        assert all(r.outcome == "served" for r in rs)
    else:
        assert [r.outcome for r in rs].count("error") == 1
    eng = server.engine
    for r, jr in zip(rs, want[1]):
        if r.outcome != "served":
            continue
        _rows_close(r.result, jr.result)
        np.testing.assert_array_equal(
            r.result, eng.cross_check(np.asarray(r.payload)[None])[0]
            .numpy())
    if site == "executor.call":          # one node count on both sides
        assert plan.log[0]["nodes"] == want[2].log[0]["nodes"]


def test_seeded_storm_replays_as_reference(engines):
    """A seeded rate plan over mixed buckets: the port replays itself
    exactly and makes the reference's decisions and outcomes."""
    specs = [dict(site="server.device", kind="device_fault", rate=0.3)]
    retry = dict(max_attempts=2, backoff_base_s=0.001, jitter=0.0)
    runs = [_summary(*_serve_under_plan(side, engines, specs, retry, n=8,
                                        seed=11))
            for side in ("port", "port", "jax")]
    assert runs[0] == runs[1] == runs[2]
    assert runs[0]["log"]


def test_latency_spike_and_backoff_on_the_server_clock(engines):
    eng = _port_engine(engines, "torch")
    server, clock = _server(eng, buckets=(1,), max_batch=1)
    server.compile_buckets()
    plan = FaultPlan([FaultSpec("server.device", "latency_spike", times=2,
                                duration_s=0.5)], sleep=clock.sleep)
    with faults.inject(plan):
        rs = [server.submit(p) for p in _images(4)]
        server.drain()
    assert all(r.outcome == "served" for r in rs)
    assert len(plan.log) == 2 and clock.t >= 1.0
    # a retried request is eligible only after the policy's backoff
    server, clock = _server(
        eng, buckets=(1,), max_batch=1,
        retry=RetryPolicy(max_attempts=2, backoff_base_s=5.0,
                          backoff_cap_s=100.0, jitter=0.0))
    with faults.inject([FaultSpec("server.device", "device_fault",
                                  times=1)]):
        r = server.submit(_images(1)[0])
        server.step(force=True)                  # dispatch
        server.step(force=True)                  # the readback faults
        assert not r.done and r.not_before == pytest.approx(5.0)
        t_before = clock.t
        server.drain()                           # sleeps out the backoff
    assert r.outcome == "served" and clock.t - t_before >= 5.0


# --------------------------------------------------------------------------
# Admission
# --------------------------------------------------------------------------

def test_admission_rejects_and_validation_off(engines):
    eng = _port_engine(engines, "torch")
    server, _ = _server(eng)
    for p in (np.zeros((4, 4, 3), np.uint8), np.array([object()]),
              np.full((*HW, 3), np.nan)):
        r = server.submit(p)
        assert r.done and r.outcome == "rejected" and r.error
    assert len(server.scheduler) == 0 and server.metrics()["rejected"] == 3
    server, _ = _server(eng, max_queue=2)
    rs = [server.submit(p) for p in _images(4)]
    assert [r.outcome for r in rs] == [None, None, "rejected", "rejected"]
    server.drain()
    assert [r.outcome for r in rs[:2]] == ["served", "served"]
    # with a preprocess hook submit cannot check the shape: a payload
    # the hook leaves too small fails at staging, alone, as error
    server, _ = _server(eng, preprocess=lambda p: p,
                        retry=RetryPolicy(max_attempts=2, jitter=0.0))
    bad = server.submit(np.zeros((4, 4, 3), np.uint8))
    good = server.submit(_images(1)[0])
    server.drain()
    assert bad.outcome == "error" and "does not fit" in bad.error
    assert good.outcome == "served" and server.metrics()["degraded"] == 0


# --------------------------------------------------------------------------
# Degradation
# --------------------------------------------------------------------------

def _demoted_run(engines, side, clock_jump: float | None):
    """Faults on the fast rung of bucket 2: demote, serve on the floor,
    then (``clock_jump``) let the quarantine expire and probe."""
    if side == "port":
        eng, cls, mod, fast = _port_engine(engines, "torch_pm1"), \
            InferenceServer, faults, "torch_pm1"
    else:
        eng, cls, mod, fast = _jax_engine(engines, "xla_pm1"), JServer, \
            j_faults, "xla_pm1"
    server, clock = _server(
        eng, cls, demote_after=2, probe_after_s=10.0,
        retry=mod.RetryPolicy(max_attempts=4, backoff_base_s=0.001,
                              jitter=0.0))
    server.compile_buckets()
    mod.install(mod.FaultPlan([mod.FaultSpec(
        "server.dispatch", "device_fault", times=2,
        match={"mode": fast, "bucket": 2})]))
    try:
        rs = [server.submit(p) for p in _images(2)]
        server.drain()
        modes = [server.health.mode_for(b) for b in (1, 2, 4)]
        r1 = [server.submit(p) for p in _images(1, seed=1)]
        r4 = [server.submit(p) for p in _images(4, seed=2)]
        server.drain()
        if clock_jump is not None:
            clock.t += clock_jump
            rs += [server.submit(p) for p in _images(2, seed=3)]
            server.drain()
    finally:
        mod.uninstall()
    flights = [{k: JAX_MODE.get(v, v) for k, v in f.items()
                if k in ("kind", "from_mode", "to_mode", "bucket")}
               for f in server.flight.dump() if f.get("kind")]
    return dict(modes=[JAX_MODE.get(m, m) for m in modes],
                after=[JAX_MODE.get(server.health.mode_for(b),
                                    server.health.mode_for(b))
                       for b in (1, 2, 4)],
                outcomes=[r.outcome for r in rs + r1 + r4],
                degraded=server.metrics()["degraded"],
                flights=flights), server, rs


@pytest.mark.parametrize("probe", [False, True], ids=["demote", "reprobe"])
def test_bucket_demotion_and_reprobe_as_reference(engines, probe):
    got, server, rs = _demoted_run(engines, "port", 60.0 if probe else None)
    want, _, jrs = _demoted_run(engines, "jax", 60.0 if probe else None)
    assert got == want
    assert got["modes"] == ["xla_pm1", "xla", "xla_pm1"]
    assert got["degraded"] == 1
    assert got["after"][1] == ("xla_pm1" if probe else "xla")
    assert all(o == "served" for o in got["outcomes"])
    bh = server.metrics()["bucket_health"]
    assert bh[2]["mode"] == ("torch_pm1" if probe else "torch")
    assert bh[1]["mode"] == "torch_pm1"
    for r, jr in zip(rs, jrs):
        _rows_close(r.result, jr.result)
    # the demoted rows are the floor's own rows, bit for bit
    floor = server.engine.compile(2, mode="torch")(torch.from_numpy(
        np.stack([np.asarray(r.payload) for r in rs[:2]])))
    np.testing.assert_array_equal(np.stack([r.result for r in rs[:2]]),
                                  floor.numpy())


def test_port_ladder_chain_demotes_and_promotes():
    """The port's own top rungs on the CPU: tiny AlexNet under
    ``cuda_chain`` (one K5 region, its plain version here) faulted at
    bucket 2 demotes that bucket to ``cuda_direct_pool``, whose executor
    is built at the bucket's next dispatch; its rows equal
    ``cross_check``; bucket 1 stays; after the quarantine a probe
    promotes bucket 2 back, building nothing."""
    wl = workloads.get("alexnet_imagenet", variant="tiny",
                       matmul_mode="cuda_chain", device="cpu")
    clock = FakeClock()
    server = wl.server(preprocess=None, buckets=(1, 2), max_batch=2,
                       clock=clock, sleep=clock.sleep, demote_after=2,
                       probe_after_s=5.0,
                       retry=RetryPolicy(max_attempts=3,
                                         backoff_base_s=0.001, jitter=0.0))
    server.compile_buckets()
    builds = wl.engine.build_count
    imgs = _images(2) + _images(1, seed=1) + _images(2, seed=2)
    plan = FaultPlan([FaultSpec("server.dispatch", "device_fault", times=2,
                                match={"mode": "cuda_chain", "bucket": 2})])
    with faults.inject(plan):
        demoted = [server.submit(p) for p in imgs[:2]]
        server.drain()
        assert server.health.mode_for(2) == "cuda_direct_pool"
        assert wl.engine.build_count == builds + 1     # built at dispatch
        one = server.submit(imgs[2])
        server.drain()
        clock.t += 10.0
        probed = [server.submit(p) for p in imgs[3:]]
        server.drain()
    assert wl.engine.build_count == builds + 1
    assert [r.outcome for r in demoted + [one] + probed] == ["served"] * 5
    assert [r.attempts for r in demoted] == [2, 2]
    m = server.metrics()
    assert m["degraded"] == 1 and m["retries"] == 4
    assert server.health.mode_for(2) == "cuda_chain" == m["mode"]
    modes = [f["mode"] for f in server.flight.dump()
             if f.get("outcome") == "served"]
    assert modes == ["cuda_direct_pool"] * 2 + ["cuda_chain"] * 3
    kinds = [f["kind"] for f in server.flight.dump() if f.get("kind")]
    assert kinds == ["demotion", "promotion"]
    for rs, xs in ((demoted, imgs[:2]), ([one], imgs[2:3]),
                   (probed, imgs[3:])):
        want = wl.engine.cross_check(np.stack(xs)).numpy()
        np.testing.assert_array_equal(np.stack([r.result for r in rs]),
                                      want)


class _CardEngine:
    """The server's view of an engine on the card: its mode, its device
    and its input shape.  Every dispatch here faults before a build, so
    nothing touches the card."""

    device = torch.device("cuda")

    def __init__(self, mode: str):
        self.matmul_mode = mode

    def _plan_shape(self, bs: int) -> tuple[int, ...]:
        return (bs, *HW, 3)

    def compile(self, *a, **kw):
        raise AssertionError("every dispatch faults before a build")


@pytest.mark.parametrize("base", ["cuda_chain", "cuda_pm1", "auto"])
def test_card_server_ladder_never_reaches_plain_torch(base):
    """A server over an engine on the card takes the card's floor: a
    bucket whose every dispatch faults walks only hand-written rungs down
    to ``cuda_popcount``, stays there, and its request resolves ``error``
    once its retries are spent (on the CPU the same faults would reach
    ``torch``)."""
    server, _ = _server(_CardEngine(base), buckets=(1,), max_batch=1,
                        demote_after=1, probe_after_s=1e9,
                        retry=RetryPolicy(max_attempts=8, jitter=0.0))
    assert server.health.ladder(1).floor == "cuda_popcount"
    with faults.inject([FaultSpec("server.dispatch", "device_fault")]) \
            as plan:
        r = server.submit(_images(1)[0])
        server.drain()
    assert r.outcome == "error" and r.attempts == 8
    tried = [f["mode"] for f in plan.log]
    assert tried[-1] == server.health.mode_for(1) == "cuda_popcount"
    assert not any(m.startswith("torch") for m in tried), tried
    m = server.metrics()
    assert m["errors"] == 1 and m["mode"] == "cuda_popcount"
    assert m["degraded"] == len(server.health.demotions) \
        == (3 if base == "cuda_chain" else 1)


# --------------------------------------------------------------------------
# Watchdog and drain
# --------------------------------------------------------------------------

def test_watchdog_times_out_a_wedged_readback(engines):
    eng = _port_engine(engines, "torch")
    server, _ = _server(eng, watchdog_s=0.2, retry=None, buckets=(1,),
                        max_batch=1)
    server.compile_buckets()
    with faults.inject([FaultSpec("server.device", "latency_spike",
                                  times=1, duration_s=2.0)],
                       sleep=time.sleep):
        r = server.submit(_images(1)[0])
        t0 = time.monotonic()
        server.drain()
        elapsed = time.monotonic() - t0
        nxt = server.submit(_images(1, seed=1)[0])
        server.drain()
    assert r.outcome == "error" and "WatchdogTimeout" in r.error
    assert elapsed < 1.5 and nxt.outcome == "served"
    # no watchdog: no reader thread
    server, _ = _server(eng, watchdog_s=None)
    n0 = threading.active_count()
    rs = [server.submit(p) for p in _images(3)]
    server.drain()
    assert all(r.outcome == "served" for r in rs)
    assert threading.active_count() == n0


def test_drain_is_bounded(engines):
    eng = _port_engine(engines, "torch")
    server, _ = _server(eng, retry=RetryPolicy(max_attempts=2,
                                               backoff_base_s=0.001,
                                               jitter=0.0))
    server.compile_buckets()
    with faults.inject([FaultSpec("server.dispatch", "device_fault")]):
        rs = [server.submit(p) for p in _images(5)]
        done = server.drain()
    assert len(server.scheduler) == 0 and server._pending is None
    assert all(r.outcome == "error" for r in rs) and len(done) == len(rs)
    server, _ = _server(eng, retry=None)
    rs = [server.submit(p) for p in _images(3)]
    done = server.drain(max_steps=0)             # an immediate abort
    assert all(r.outcome == "error" and "wedged" in r.error for r in rs)
    assert len(done) == 3
    assert [f["outcome"] for f in server.flight.dump()] == ["error"] * 3


# --------------------------------------------------------------------------
# Multiplexer
# --------------------------------------------------------------------------

def test_degradation_is_per_tenant(engines):
    """Faults matched to tenant a demote a's ladder only: b keeps serving
    on ``torch_pm1``, its rows that mode's own."""
    a, b = (_port_engine(engines, "torch_pm1") for _ in range(2))
    clock = FakeClock()
    mux = MultiTenantServer(clock=clock, sleep=clock.sleep, buckets=(1,),
                            max_batch=1, max_wait_s=0.0, demote_after=1,
                            probe_after_s=1000.0,
                            retry=RetryPolicy(max_attempts=4,
                                              backoff_base_s=0.001,
                                              jitter=0.0))
    mux.add_tenant("a", a)
    mux.add_tenant("b", b)
    with faults.inject([FaultSpec("server.dispatch", "device_fault",
                                  match={"tenant": "a",
                                         "mode": "torch_pm1"})]):
        ra = [mux.submit("a", i) for i in _images(2)]
        rb = [mux.submit("b", i) for i in _images(2, seed=1)]
        mux.drain()
    assert all(r.outcome == "served" for r in ra + rb)
    assert mux.server("a").health.mode == "torch"
    assert mux.server("b").health.mode == "torch_pm1"
    assert mux.server("a").metrics()["degraded"] == 1
    assert mux.server("b").metrics()["degraded"] == 0
    img = _images(2, seed=1)[0]
    want = b.compile(1, mode="torch_pm1")(torch.from_numpy(img[None]))[0]
    np.testing.assert_array_equal(rb[0].result, want.numpy())


def test_arbiter_sleeps_when_every_lane_is_in_backoff(engines):
    """Both lanes' only requests fault once and back off 5 s: no lane is
    ready, so ``drain`` waits through the multiplexer's ``sleep`` (the
    lanes' own are never called) and then serves both."""
    eng = _port_engine(engines, "torch")
    clock = FakeClock()
    lane_sleeps, mux_sleeps = [], []

    def mux_sleep(s):
        mux_sleeps.append(s)
        clock.sleep(s)
    mux = MultiTenantServer(clock=clock, sleep=mux_sleep, buckets=(1,),
                            max_batch=1, max_wait_s=0.0,
                            retry=RetryPolicy(max_attempts=2,
                                              backoff_base_s=5.0,
                                              backoff_cap_s=100.0,
                                              jitter=0.0))
    for t in ("a", "b"):
        mux.add_tenant(t, eng, sleep=lane_sleeps.append)
    with faults.inject([FaultSpec("server.dispatch", "device_fault",
                                  times=2)]):
        rs = [mux.submit(t, _images(1)[0]) for t in ("a", "b")]
        assert mux._pick(clock()) is not None
        mux.step(force=True)
        mux.step(force=True)
        assert all(r.not_before == pytest.approx(5.0) for r in rs)
        assert mux._pick(clock()) is None          # starved by backoff
        mux.drain()
    assert [r.outcome for r in rs] == ["served", "served"]
    assert mux_sleeps and sum(mux_sleeps) >= 5.0 - 1e-9
    assert lane_sleeps == []


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_fault_storm_prints_resilience():
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--workload", "alexnet_imagenet", "--variant", "tiny",
         "--requests", "4", "--fault-storm"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "fault storm installed (seed 7)" in out.stdout
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("[bnn] resilience:"))
    assert "retries" in line
    # how the storm's rate faults fall depends on real-time batching
    assert "[bnn] served " in out.stdout and "[bnn] storm: " in out.stdout


# --------------------------------------------------------------------------
# Executor: the traced walk
# --------------------------------------------------------------------------

def test_traced_call_as_reference(engines):
    """One span a node, bit-exact with the fused call, and the reference's
    span names and output shapes on the same graph (port ``torch``,
    reference ``xla``); a chain executor reports its K5 region as one
    ``region.*`` span."""
    x = np.stack(_images(2))
    port = _port_engine(engines, "torch").compile(2, capture=False)
    ref = _jax_engine(engines, "xla").compile(2)
    spans = {}
    for side, exe, mod, arg in (("port", port, trace, torch.from_numpy(x)),
                                ("jax", ref, j_trace, x)):
        tracer = mod.install()
        try:
            got = exe.traced_call(arg)
            want = exe(arg)
        finally:
            mod.uninstall()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        spans[side] = [(e["name"], e["args"].get("shape"))
                       for e in tracer.spans("node.")]
        (walk,) = tracer.spans("executor.traced_call")
        assert walk["args"]["nodes"] >= len(spans[side]) >= 3
    assert spans["port"] == spans["jax"]
    _rows_close(port(torch.from_numpy(x)), ref(x))
    wl = workloads.get("alexnet_imagenet", variant="tiny", device="cpu",
                       matmul_mode="cuda_chain")
    exe = wl.engine.engine.compile(1, capture=False)
    xt = torch.from_numpy(np.stack(_images(1)))
    tracer = trace.install()
    try:
        got = exe.traced_call(xt)
    finally:
        trace.uninstall()
    assert torch.equal(got, exe(xt))
    regions = tracer.spans("region.")
    assert len(regions) == len(exe.regions) == 1
    assert regions[0]["args"]["op"] == "chain"


def test_cli_modes_in_process(tmp_path, capsys):
    """The launcher's other modes on the CPU: an artifact export, a boot
    from it that replays a journal and writes a trace, a multi-tenant run
    and the LM demo."""
    base = ["--device", "cpu", "--variant", "tiny", "--batch", "2"]
    art, jpath = str(tmp_path / "art"), str(tmp_path / "j.jsonl")
    meta = cli.main(base + ["--workload", "alexnet_imagenet",
                            "--export-artifact", art])
    assert sorted(int(b) for b in meta["buckets"]) == [1, 2]
    from repro_torch.serving.recovery import RequestJournal
    j = RequestJournal(jpath)
    j.submit("bnn", np.zeros((20, 30, 3), np.uint8))     # left open
    j.close()
    m = cli.main(base + ["--workload", "alexnet_imagenet", "--artifact",
                         art, "--journal", jpath, "--requests", "3",
                         "--trace-out", str(tmp_path / "t.json")])
    assert m["served"] == 4 and m["retries"] == m["degraded"] == 0
    assert not RequestJournal.scan(jpath).unresolved
    m = cli.main(base + ["--workloads", "alexnet_imagenet:3,vgg16_imagenet",
                         "--requests", "2"])
    assert {t: tm["served"] for t, tm in m["tenants"].items()} \
        == {"alexnet_imagenet": 2, "vgg16_imagenet": 2}
    m = cli.main(["--mode", "lm", "--device", "cpu", "--requests", "2",
                  "--batch", "2", "--max-seq", "32", "--max-new", "3"])
    assert m["served"] == 2
    out = capsys.readouterr().out
    assert "replaying 1 unresolved request(s)" in out
    assert "loaded buckets [1, 2]" in out and "trace events" in out
    assert "[lm] 6 tokens" in out
