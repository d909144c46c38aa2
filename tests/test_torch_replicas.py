"""Port parity: replica groups and the straggler monitor
(``repro_torch.distributed``) against ``repro.distributed``, in-process on
the CPU with one device listed per replica (``[torch.device("cpu")] * 2``
beside ``[jax.devices()[0]] * 2``, as ``tests/test_distributed.py`` runs
the reference).

* **StragglerMonitor** — on one step-time sequence the port's and the
  reference's monitors flag the same steps, call the same hooks and keep
  the same mean.
* **ReplicaGroup** — under one fake clock and one submission sequence
  (pinned and routed submits between ticks) the port's group and the
  reference's send each request to the same replica and serve the same
  rows (the packed net's words, exactly); after a monitor flags a lane,
  and after it recovers, they route alike.  The port's rows equal the
  single engine's bit for bit and nothing is built while serving; each
  replica's engine is a view sharing the packed tensors; replicas of
  pipelines serve the same rows.
* **Replica-scoped faults** — ``tests/test_resilience.py``'s
  ``TestDistributedFaults`` on the port (``torch_pm1`` demoting to
  ``torch``): a fault on one replica quarantines only it, it re-probes and
  promotes, unpinned traffic avoids it; one case also against the
  reference's group under one plan (outcomes, attempts, ladders, routing).
* **LMReplicaGroup** — ``tests/test_recovery.py``'s ``TestMigration`` on
  the same tiny ``LMConfig`` (JAX params carried as numpy), port against
  reference: a quarantined lane evacuates to the healthy one, the emitted
  prefix is kept, routing steers around the quarantined lane; the lanes
  share one params dict.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import bnn_model as j_bnn
from repro.distributed import LMReplicaGroup as JLMReplicaGroup
from repro.distributed import ReplicaGroup as JReplicaGroup
from repro.distributed import StragglerMonitor as JStragglerMonitor
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as j_tf
from repro.serving import PhoneBitEngine as JEngine
from repro.serving import faults as j_faults
from repro_torch.core.bnn_model import BConv, BDense, Pool
from repro_torch.distributed import (LMReplicaGroup, ReplicaGroup,
                                     StragglerMonitor)
from repro_torch.kernels.ops import JAX_MODE
from repro_torch.models import transformer as t_tf
from repro_torch.serving import PhoneBitEngine, faults
from repro_torch.serving.faults import FaultPlan, FaultSpec, RetryPolicy

CPU = torch.device("cpu")
HW = (16, 16)


class _Port:
    BConv, BDense, Pool = BConv, BDense, Pool


def _spec(mod):
    """The reference test's packed-tail net: its rows are int32 words."""
    return [mod.BConv(3, 32, kernel=3, stride=1, pad=1, first=True),
            mod.BConv(32, 32, kernel=3, stride=1, pad=1),
            mod.Pool(2, 2), mod.BDense(8 * 8 * 32, 64)]


class FakeClock:
    """Monotonic fake clock; ``sleep`` advances it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += max(s, 0.0)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    faults.uninstall()
    j_faults.uninstall()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny shapes here run faster on one intra-op thread than on a
    pool the suite's parallel workers all share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """(the port's engine in ``torch`` on the CPU, the JAX engine in
    ``xla``) on the same params, built once."""
    jp = j_bnn.init_params(jax.random.key(0), _spec(j_bnn))
    port = PhoneBitEngine.from_trained(
        [{k: np.asarray(v) for k, v in p.items()} for p in jp],
        _spec(_Port), HW, matmul_mode="torch", device="cpu")
    return port, JEngine.from_trained(jp, _spec(j_bnn), HW)


def _mode(engines, side: str, mode: str):
    base = engines[0] if side == "port" else engines[1]
    if side == "port":
        return PhoneBitEngine(spec=base.spec, packed=base.packed,
                              input_hw=base.input_hw, matmul_mode=mode,
                              device="cpu")
    return JEngine(spec=base.spec, packed=base.packed,
                   input_hw=base.input_hw, matmul_mode=mode)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
            for _ in range(n)]


def _devices(side: str, n: int) -> list:
    return [CPU] * n if side == "port" else [jax.devices()[0]] * n


# --------------------------------------------------------------------------
# StragglerMonitor
# --------------------------------------------------------------------------

STEP_TIMES = {
    "spikes": [0.01] * 12 + [0.05, 0.011, 0.06, 0.07, 0.08, 0.09, 0.1,
                             0.012, 0.2],
    "drift": [0.01 + 0.001 * i for i in range(15)] + [0.5] * 7,
    "noisy": list(np.random.default_rng(5).uniform(0.008, 0.02, 30))
    + [0.04, 0.041, 0.042],
}


@pytest.mark.parametrize("seq", list(STEP_TIMES))
def test_straggler_flags_as_reference(seq):
    out = {}
    for side, cls in (("port", StragglerMonitor), ("jax", JStragglerMonitor)):
        calls = []
        mon = cls(persistent_after=2,
                  on_warn=lambda s, dt, m: calls.append(("warn", s)),
                  on_persistent=lambda s: calls.append(("persistent", s)))
        flags = [mon.observe(i, dt) for i, dt in enumerate(STEP_TIMES[seq])]
        out[side] = (flags, mon.flagged_steps, calls, mon.mean_step_time)
    assert out["port"] == out["jax"]
    assert any(out["port"][0])


def test_straggler_start_stop():
    mon = StragglerMonitor()
    with pytest.raises(RuntimeError):
        mon.stop(0)
    mon.start()
    assert mon.stop(0) is False and mon._n == 1


# --------------------------------------------------------------------------
# ReplicaGroup
# --------------------------------------------------------------------------

def _where(grp, before: dict) -> str:
    """The replica whose queue grew since ``before``."""
    after = {n: r.server.queue_depth for n, r in grp.replicas.items()}
    grown = [n for n in after if after[n] > before[n]]
    assert len(grown) == 1
    return grown[0]


def _routed_run(side, engines):
    """One submission sequence under a fake clock: returns the replica of
    each request, the requests and the group."""
    cls = ReplicaGroup if side == "port" else JReplicaGroup
    clock = FakeClock()
    grp = cls(_mode(engines, side, "torch" if side == "port" else "xla"),
              _devices(side, 2), clock=clock, sleep=clock.sleep,
              buckets=(1, 2, 4), max_batch=4)
    imgs = _images(11, seed=3)
    pins = [None, "r0", None, None, "r1", "r1", None, None, "r0", None,
            None]
    where, reqs = [], []
    for i, (img, pin) in enumerate(zip(imgs, pins)):
        before = {n: r.server.queue_depth for n, r in grp.replicas.items()}
        reqs.append(grp.submit(img, replica=pin))
        where.append(_where(grp, before))
        if i % 4 == 3:
            grp.step(force=True)
        clock.t += 0.001
    grp.drain()
    return where, reqs, grp


def test_routing_and_rows_as_reference(engines):
    got_where, got, grp = _routed_run("port", engines)
    want_where, want, _ = _routed_run("jax", engines)
    assert got_where == want_where
    assert set(got_where) == {"r0", "r1"}
    single = engines[0].compile(1, capture=False)
    for r, j in zip(got, want):
        assert r.outcome == j.outcome == "served"
        np.testing.assert_array_equal(r.result, np.asarray(j.result))
        np.testing.assert_array_equal(
            r.result, single(torch.as_tensor(r.payload)[None])[0].numpy())
    m = grp.metrics()
    assert set(m["replicas"]) == {"r0", "r1"}
    assert all(v["healthy"] and v["devices"] == ["cpu"]
               for v in m["routing"].values())
    assert [m["replicas"][n]["tenant"] for n in ("r0", "r1")] == \
        ["r0", "r1"]


def test_serves_bit_exact_and_builds_nothing(engines):
    eng = engines[0]
    grp = ReplicaGroup(eng, [CPU] * 2, buckets=(2, 4), max_batch=4)
    grp.compile_buckets()
    builds = grp.build_count
    imgs = _images(6)
    reqs = [grp.submit(i) for i in imgs]
    grp.drain()
    assert grp.build_count == builds == 4
    ref = eng.compile(6, capture=False)(torch.as_tensor(np.stack(imgs)))
    for i, r in enumerate(reqs):
        assert r.outcome == "served"
        np.testing.assert_array_equal(r.result, ref[i].numpy())
    # Views: the packed tensors are the engine's, the caches their own.
    for rep in grp.replicas.values():
        view = rep.server.engine
        assert view is not eng and view.packed[0]["w_packed"] is \
            eng.packed[0]["w_packed"]
        assert rep.server.pipeline_devices == (CPU,)
    a, b = (r.server.engine for r in grp.replicas.values())
    assert a._compiled.keys() == b._compiled.keys()
    assert all(a._compiled[k] is not b._compiled[k] for k in a._compiled)


def test_slow_replica_routing_as_reference(engines):
    """The same synthetic step times flag r1 in both groups; both route
    unpinned traffic to r0 until a clean step brings r1 back."""
    out = {}
    for side, cls in (("port", ReplicaGroup), ("jax", JReplicaGroup)):
        grp = cls(engines[0] if side == "port" else engines[1],
                  _devices(side, 2), slow_after=2, buckets=(1, 2),
                  max_batch=2)
        r1 = grp.replicas["r1"]
        for i in range(r1.monitor.min_samples):
            grp._observe_step(r1, 0.01, i)
        seen = []
        for i in range(3):
            grp._observe_step(r1, 10.0, 100 + i)
            seen.append((r1.slow, r1.healthy))
        routed = [grp._route().name for _ in range(4)]
        grp._observe_step(r1, 0.01, 200)
        seen.append((r1.slow, r1.healthy))
        routed += [grp._route().name for _ in range(4)]
        out[side] = (seen, routed, grp.metrics()["routing"]["r1"]["slow"])
    assert out["port"] == out["jax"]
    assert out["port"][1][:4] == ["r0"] * 4
    assert set(out["port"][1][4:]) == {"r0", "r1"}


def test_replicas_of_pipelines(engines):
    eng = engines[0]
    grp = ReplicaGroup(eng, [CPU] * 4, devices_per_replica=2,
                       buckets=(2,), max_batch=2)
    imgs = _images(4, seed=8)
    reqs = [grp.submit(i) for i in imgs]
    grp.drain()
    ref = eng.compile(4, capture=False)(torch.as_tensor(np.stack(imgs)))
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.result, ref[i].numpy())
    for rep in grp.replicas.values():
        assert rep.server.pipeline_devices == (CPU, CPU)
        assert rep.server.metrics()["placement"]["devices"] == ["cpu"] * 2


def test_shape_validation(engines):
    with pytest.raises(ValueError):
        ReplicaGroup(engines[0], [CPU] * 3, devices_per_replica=2)
    with pytest.raises(ValueError):
        ReplicaGroup(engines[0], [CPU] * 2, names=("a",))
    with pytest.raises(ValueError):
        ReplicaGroup(engines[0], [CPU], devices_per_replica=2)


# --------------------------------------------------------------------------
# Replica-scoped faults (tests/test_resilience.py TestDistributedFaults)
# --------------------------------------------------------------------------

def _fault_group(engines, side="port", **kw):
    """One rung above the floor (``torch_pm1`` / ``xla_pm1``), so there is
    somewhere to demote to."""
    cls = ReplicaGroup if side == "port" else JReplicaGroup
    mod = faults if side == "port" else j_faults
    clock = FakeClock()
    kw.setdefault("retry", mod.RetryPolicy(max_attempts=4,
                                           backoff_base_s=0.001, jitter=0.0))
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_s", 0.0)
    eng = _mode(engines, side, "torch_pm1" if side == "port" else "xla_pm1")
    return cls(eng, _devices(side, 2), clock=clock, sleep=clock.sleep,
               **kw), clock


def _one_replica_fault(side, engines, site, kind):
    grp, _ = _fault_group(engines, side, demote_after=1,
                          probe_after_s=1000.0)
    grp.compile_buckets()
    mod = faults if side == "port" else j_faults
    match = {"tenant": "r1"}
    extra = {}
    if site == "server.dispatch":
        # The configured rung alone faults: the demoted floor serves.
        match["mode"] = "torch_pm1" if side == "port" else "xla_pm1"
    else:
        extra["times"] = 2      # readback: no mode in its context
    imgs = _images(4)
    with mod.inject([mod.FaultSpec(site, kind, match=match, **extra)]) \
            as plan:
        rs = [grp.submit(p, replica=("r1" if i % 2 else "r0"))
              for i, p in enumerate(imgs)]
        grp.drain()
    return grp, rs, imgs, plan


@pytest.mark.parametrize("site,kind", [
    ("server.dispatch", "device_fault"),
    ("server.dispatch", "device_oom"),
    ("server.device", "device_fault"),
    ("server.device", "device_oom"),
])
def test_fault_on_one_replica_quarantines_only_it(engines, site, kind):
    grp, rs, imgs, _ = _one_replica_fault("port", engines, site, kind)
    assert all(r.outcome == "served" for r in rs)
    r0, r1 = grp.replicas["r0"], grp.replicas["r1"]
    assert r1.server.health.mode == "torch"          # demoted
    assert r1.server.metrics()["degraded"] >= 1 and not r1.healthy
    assert r0.server.health.mode == "torch_pm1"      # untouched
    m0 = r0.server.metrics()
    assert m0["degraded"] == 0 and m0["retries"] == 0 and r0.healthy
    assert grp._route().name == "r0"
    assert grp.metrics()["routing"]["r1"]["healthy"] is False
    ref = r0.server.engine.compile(4, capture=False)(
        torch.as_tensor(np.stack(imgs)))
    for i, r in enumerate(rs):
        np.testing.assert_array_equal(r.result, ref[i].numpy())


def test_one_replica_fault_as_reference(engines):
    """One plan on both groups: the same outcomes, attempts, fault log,
    per-replica ladders and routing."""
    out = {}
    for side in ("port", "jax"):
        grp, rs, _, plan = _one_replica_fault(side, engines,
                                              "server.dispatch",
                                              "device_fault")
        routing = grp.metrics()["routing"]
        out[side] = dict(
            outcomes=[(r.outcome, r.attempts) for r in rs],
            fired=len(plan.log),
            modes={n: JAX_MODE.get(v["mode"], v["mode"])
                   for n, v in routing.items()},
            healthy={n: v["healthy"] for n, v in routing.items()},
            counters={n: {k: rep.server.metrics()[k]
                          for k in ("served", "retries", "degraded")}
                      for n, rep in grp.replicas.items()},
            route=grp._route().name)
    assert out["port"] == out["jax"]


def test_sick_replica_reprobes_and_promotes(engines):
    grp, clock = _fault_group(engines, demote_after=1, probe_after_s=10.0)
    grp.compile_buckets()
    with faults.inject([FaultSpec("server.dispatch", "device_fault",
                                  times=1, match={"tenant": "r1",
                                                  "mode": "torch_pm1"})]):
        rs = [grp.submit(p, replica="r1") for p in _images(2)]
        grp.drain()
        r1 = grp.replicas["r1"]
        assert r1.server.health.mode == "torch" and not r1.healthy
        clock.t += 60.0                 # quarantine expires
        # The demotion hit the 2-bucket: its probe needs 2-bucket traffic.
        r2 = [grp.submit(p, replica="r1") for p in _images(2)]
        grp.drain()
    assert all(r.outcome == "served" for r in rs + r2)
    assert r1.server.health.mode == "torch_pm1" and r1.healthy
    assert grp.metrics()["routing"]["r1"]["healthy"] is True
    promos = [f for f in r1.server.flight.dump()
              if f.get("kind") == "promotion"]
    assert promos and promos[-1]["to_mode"] == "torch_pm1"
    assert grp.replicas["r0"].server.health.mode == "torch_pm1"


def test_unpinned_traffic_avoids_quarantined_replica(engines):
    grp, _ = _fault_group(engines, demote_after=1, probe_after_s=1000.0)
    grp.compile_buckets()
    with faults.inject(FaultPlan([FaultSpec(
            "server.dispatch", "device_fault",
            match={"tenant": "r1", "mode": "torch_pm1"})])):
        warm = [grp.submit(p, replica="r1") for p in _images(2)]
        grp.drain()
        assert not grp.replicas["r1"].healthy
        rs = [grp.submit(p) for p in _images(4)]
        r1_before = grp.replicas["r1"].server.metrics()["served"]
        grp.drain()
    assert all(r.outcome == "served" for r in warm + rs)
    assert grp.replicas["r1"].server.metrics()["served"] == r1_before
    assert grp.replicas["r0"].server.metrics()["served"] == 4


def test_drain_is_bounded(engines):
    grp, _ = _fault_group(engines, retry=RetryPolicy(max_attempts=100,
                                                     backoff_base_s=0.0,
                                                     jitter=0.0))
    with faults.inject([FaultSpec("server.device", "device_fault")]):
        rs = [grp.submit(p) for p in _images(3)]
        grp.drain(max_steps=5)
    assert all(r.done for r in rs)
    assert {r.outcome for r in rs} == {"error"}


# --------------------------------------------------------------------------
# LMReplicaGroup (tests/test_recovery.py TestMigration)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """The reference test's tiny config: (port cfg, JAX cfg, rules, mesh,
    JAX params, the port's params on the CPU)."""
    kw = dict(name="t", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=64, vocab=64, tie_embeddings=True)
    jcfg, tcfg = j_tf.LMConfig(**kw), t_tf.LMConfig(**kw)
    mesh = make_host_mesh(data=1, model=1)
    with mesh:
        jp = j_tf.init_params(jax.random.key(0), jcfg, ep=1)
    return dict(tcfg=tcfg, jcfg=jcfg, rules=rules_for_mesh(mesh), mesh=mesh,
                jp=jp, tp=t_tf.params_from_numpy(
                    jax.tree.map(np.asarray, jp), tcfg, "cpu"))


def _lm_group(side, lm, **kw):
    kw = dict(n_slots=2, max_seq=32, n_lanes=2, clock=FakeClock(), **kw)
    if side == "port":
        return LMReplicaGroup(lm["tcfg"], None, lm["tp"], device="cpu", **kw)
    return JLMReplicaGroup(lm["jcfg"], lm["rules"], lm["jp"], **kw)


def _lm_fault(side):
    mod = faults if side == "port" else j_faults
    return mod.inject([mod.FaultSpec("lm.step", "device_fault", times=1000,
                                     match={"tenant": "lm0"})])


def _both(lm, run):
    """``run(side, group)`` for the port and the reference."""
    out = {}
    with lm["mesh"]:
        for side in ("port", "jax"):
            out[side] = run(side)
    assert out["port"] == out["jax"]
    return out["port"]


def test_quarantined_lane_evacuates_to_healthy_lane(lm):
    def run(side):
        grp = _lm_group(side, lm, checkpoint_every=2,
                        max_restore_attempts=1, probe_after_s=30.0)
        r = grp.submit([1, 2, 3], max_new=8, lane="lm0")
        with _lm_fault(side):
            grp.drain()
        lm0 = grp.lanes["lm0"]
        adopted = [f for f in grp.lanes["lm1"].server.flight.dump()
                   if f.get("kind") == "migration"]
        m = grp.metrics()
        return dict(outcome=r.outcome, n=len(r.result),
                    migrations=grp.migrations, quarantines=lm0.quarantines,
                    quarantined=lm0.quarantined(grp.clock()),
                    src=[f["src"] for f in adopted],
                    routing={n: {k: v[k] for k in ("quarantined",
                                                   "quarantines",
                                                   "evacuations")}
                             for n, v in m["routing"].items()},
                    m_migrations=m["migrations"])
    got = _both(lm, run)
    assert got["outcome"] == "served" and got["n"] == 8
    assert got["migrations"] == 1 and got["quarantined"]
    assert got["src"] == ["lm0"]


def test_migration_preserves_emitted_prefix(lm):
    def run(side):
        grp = _lm_group(side, lm, checkpoint_every=1,
                        max_restore_attempts=1)
        r = grp.submit([1, 2, 3], max_new=8, lane="lm0")
        s0 = grp.lanes["lm0"].server
        for _ in range(3):
            grp.serve_tick()
        prefix = list(next(iter(s0.manager.active.values())).tokens)
        with _lm_fault(side):
            grp.drain()
        return dict(outcome=r.outcome, prefix=prefix,
                    kept=list(r.result[:len(prefix)]) == prefix,
                    n=len(r.result), migrations=grp.migrations)
    got = _both(lm, run)
    assert got["outcome"] == "served" and got["prefix"] and got["kept"]


def test_routing_steers_around_quarantined_lane(lm):
    def run(side):
        grp = _lm_group(side, lm, checkpoint_every=2,
                        max_restore_attempts=1)
        r = grp.submit([1, 2, 3], max_new=4, lane="lm0")
        with _lm_fault(side):
            grp.drain()
        r2 = grp.submit([4, 5], max_new=4)
        depths = [grp.lanes[n].server.queue_depth for n in ("lm0", "lm1")]
        grp.drain()
        return dict(outcomes=[r.outcome, r2.outcome],
                    migrations=grp.migrations, depths=depths)
    got = _both(lm, run)
    assert got == dict(outcomes=["served", "served"], migrations=1,
                       depths=[0, 1])


def test_lanes_share_params_and_own_caches(lm):
    grp = _lm_group("port", lm)
    a, b = (ln.server for ln in grp.lanes.values())
    assert a.params is b.params is lm["tp"]
    assert a.cache is not b.cache
    assert a.tenant == "lm0" and b.tenant == "lm1"
    assert a.evacuate is not None and b.evacuate is not None


# --------------------------------------------------------------------------
# LMReplicaGroup(rules=): lanes sharded over a (1, 4) mesh
# --------------------------------------------------------------------------

def _evacuation(grp, mod) -> dict:
    """lm0 serves one request 3 ticks, then its decode faults past its
    restore: the flight migrates to lm1 and is served."""
    r = grp.submit([1, 2, 3], max_new=8, lane="lm0")
    for _ in range(3):
        grp.serve_tick()
    prefix = list(next(iter(
        grp.lanes["lm0"].server.manager.active.values())).tokens)
    with mod.inject([mod.FaultSpec("lm.step", "device_fault", times=1000,
                                   match={"tenant": "lm0"})]):
        grp.drain()
    return dict(outcome=r.outcome, tokens=[int(t) for t in r.result],
                prefix=prefix, migrations=grp.migrations,
                quarantined=grp.lanes["lm0"].quarantined(grp.clock()))


def sharded_lanes_rank(rank, device, cfg, jp_np):
    """One rank of a (1, 4) mesh: a two-lane group over the rank's slices,
    through the forced evacuation."""
    from repro_torch.distributed import sharding as t_sharding
    from repro_torch.launch import mesh as mesh_lib

    rules = t_sharding.rules_for_mesh(mesh_lib.make_host_mesh(
        data=1, model=4, device=device))
    params = t_tf.params_from_numpy(jp_np, cfg, "cpu", rules=rules)
    grp = LMReplicaGroup(cfg, rules, params, n_slots=2, max_seq=32,
                         n_lanes=2, clock=FakeClock(), device="cpu",
                         checkpoint_every=1, max_restore_attempts=1)
    return _evacuation(grp, faults)


def test_sharded_lanes_evacuate_as_one_device_and_reference(lm, tmp_path):
    """``LMReplicaGroup(cfg, rules, params)`` on 4 gloo ranks over (1, 4):
    every rank serves the same tokens and migrations as the one-device
    group and the reference's group built with ``lm["rules"]``."""
    from repro_torch.launch import mesh as mesh_lib

    kw = dict(checkpoint_every=1, max_restore_attempts=1)
    one = _evacuation(_lm_group("port", lm, **kw), faults)
    with lm["mesh"]:
        ref = _evacuation(_lm_group("jax", lm, **kw), j_faults)
    ranks = mesh_lib.spawn(sharded_lanes_rank, 4, lm["tcfg"],
                           jax.tree.map(np.asarray, lm["jp"]),
                           device="cpu", threads=1, timeout_s=240,
                           workdir=str(tmp_path))
    assert one == ref
    assert one["outcome"] == "served" and one["migrations"] == 1
    assert one["tokens"][:len(one["prefix"])] == one["prefix"]
    for got in ranks:
        assert got == one
