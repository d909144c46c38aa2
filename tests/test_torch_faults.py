"""Port parity: the fault-injection vocabulary (``repro_torch.serving.
faults``) against the reference's (``repro.serving.faults``).

* ``FaultPlan``: the reference's schedule, rate, match, latency-spike,
  log and counter cases on the port, and both packages' plans given the
  same specs and seed over one 200-call stream of site calls: the same
  fire decisions and the same logs;
* ``RetryPolicy``: the same backoff sequences (seeded jitter and none)
  and the same validation;
* ``BackendHealth`` / ``BucketHealth``: one stream of failures,
  successes, probes and promotions through both packages gives the same
  modes, demotions and snapshots, port modes mapped through
  ``kernels.ops.JAX_MODE``; the port's ladder is the reference's ladder
  through the same table;
* the card's floor: a ladder on the card ends at ``cuda_popcount``, the
  last hand-written rung, and never reaches a plain PyTorch rung.
"""

import numpy as np
import pytest
import torch

from repro.serving import faults as j_faults
from repro_torch.kernels.ops import JAX_MODE
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import faults
from repro_torch.serving.faults import (DEGRADE_LADDER, BackendHealth,
                                        BucketHealth, DeviceFault,
                                        FaultPlan, FaultSpec, RetryPolicy,
                                        demote_mode, ladder_floor)

@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    faults.uninstall()
    j_faults.uninstall()


def _map_modes(obj):
    """``obj`` with every port mode name replaced by its JAX mode."""
    if isinstance(obj, dict):
        return {_map_modes(k): _map_modes(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map_modes(v) for v in obj]
    if isinstance(obj, str):
        return JAX_MODE.get(obj, obj)
    return obj


# --------------------------------------------------------------------------
# The vocabulary
# --------------------------------------------------------------------------

def test_taxonomy_as_reference():
    assert faults.SITES == j_faults.SITES
    assert set(faults.FAULT_KINDS) == set(j_faults.FAULT_KINDS)
    assert faults.LATENCY_SPIKE == j_faults.LATENCY_SPIKE
    for kind, cls in faults.FAULT_KINDS.items():
        ref = j_faults.FAULT_KINDS[kind]
        assert (cls.__name__, cls.transient) == (ref.__name__, ref.transient)
        assert issubclass(cls, faults.FaultError)
    e = faults.DeviceOOM("server.device", bucket=4)
    assert (e.site, e.ctx) == ("server.device", {"bucket": 4})
    assert str(e) == str(j_faults.DeviceOOM("server.device", bucket=4))


def test_ladder_is_the_reference_ladder():
    assert tuple(JAX_MODE[m] for m in DEGRADE_LADDER) \
        == j_faults.DEGRADE_LADDER
    mode, seen = DEGRADE_LADDER[0], [DEGRADE_LADDER[0]]
    while (mode := demote_mode(mode)) is not None:
        seen.append(mode)
    assert tuple(seen) == DEGRADE_LADDER
    # outside the ladder: straight to the floor, as mxu_pm1 and auto
    assert demote_mode("cuda_pm1") == "torch"
    assert demote_mode("auto") == "torch"
    assert j_faults.demote_mode("mxu_pm1") == "xla"
    for m in (*DEGRADE_LADDER, "cuda_pm1", "auto"):
        assert faults.ladder_rank(m) == j_faults.ladder_rank(
            JAX_MODE.get(m, m))


# --------------------------------------------------------------------------
# Fault plans
# --------------------------------------------------------------------------

def test_unknown_site_and_kind_rejected():
    with pytest.raises(ValueError, match="site"):
        FaultSpec("nope.where", "device_oom")
    with pytest.raises(ValueError, match="kind"):
        FaultSpec("server.device", "gremlins")


def test_schedule_after_every_times():
    plan = FaultPlan([FaultSpec("server.device", "device_fault",
                                after=2, every=2, times=2)])
    fired = []
    for _ in range(10):
        try:
            plan.check("server.device")
            fired.append(False)
        except DeviceFault:
            fired.append(True)
    assert fired == [False, False, True, False, True,
                     False, False, False, False, False]


def test_match_spike_log_and_counter():
    plan = FaultPlan([FaultSpec("server.dispatch", "device_oom",
                                match={"mode": "cuda_chain"})])
    plan.check("server.dispatch", mode="torch")          # no fire
    with pytest.raises(faults.DeviceOOM):
        plan.check("server.dispatch", mode="cuda_chain")
    slept = []
    plan = FaultPlan([FaultSpec("server.device", "latency_spike",
                                duration_s=0.25)], sleep=slept.append)
    plan.check("server.device")
    assert slept == [0.25] and plan.log[0]["kind"] == "latency_spike"
    with obs_metrics.use_registry() as reg:
        with faults.inject([FaultSpec("server.device",
                                      "device_fault")]) as plan:
            with pytest.raises(DeviceFault):
                faults.maybe_fault("server.device", bucket=4)
        assert plan.fired("server.device")[0]["bucket"] == 4
        assert reg.snapshot()["faults.injected"] == 1
        assert reg.events("fault")[0]["site"] == "server.device"
    assert faults.get_plan() is None
    faults.maybe_fault("server.device")                  # disabled: no-op


SPECS = [
    dict(site="server.device", kind="device_fault", rate=0.3),
    dict(site="server.device", kind="latency_spike", rate=0.2,
         duration_s=0.01),
    dict(site="server.dispatch", kind="device_oom", after=3, every=4,
         times=5, match={"bucket": 8}),
    dict(site="executor.call", kind="device_fault", rate=0.1, times=6),
    dict(site="lm.step", kind="device_fault", after=10, every=7),
    dict(site="kv.snapshot", kind="device_fault", rate=0.5,
         match={"reason": "cadence"}),
]


def _site_stream(n: int = 200):
    """A seeded stream of site calls with varied ctx."""
    rng = np.random.default_rng(42)
    sites = ["server.device", "server.dispatch", "executor.call", "lm.step",
             "kv.snapshot", "server.preprocess"]
    for _ in range(n):
        site = sites[int(rng.integers(len(sites)))]
        ctx = {"server.dispatch": {"bucket": int(rng.choice([1, 8]))},
               "kv.snapshot": {"reason": str(rng.choice(["cadence",
                                                         "admission"]))},
               }.get(site, {"bucket": int(rng.integers(1, 9))})
        yield site, ctx


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_plan_decisions_and_log_as_reference(seed):
    """The same specs and seed over one 200-call stream: the same fire
    decisions (raise, spike or pass) and the same logs in both
    packages."""
    def run(mod):
        slept = []
        plan = mod.FaultPlan([mod.FaultSpec(**s) for s in SPECS], seed=seed,
                             sleep=slept.append)
        decisions = []
        for site, ctx in _site_stream():
            try:
                plan.check(site, **ctx)
                decisions.append("pass")
            except mod.FaultError as e:
                decisions.append(e.kind)
        return decisions, plan.log, slept

    got, want = run(faults), run(j_faults)
    assert got == want
    assert sum(d != "pass" for d in got[0]) > 10      # the stream did fire
    assert got[2]                                       # and stalled


# --------------------------------------------------------------------------
# Retry policy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(max_attempts=5, backoff_base_s=0.1, backoff_cap_s=0.35,
         jitter=0.0),
    dict(backoff_base_s=0.1, jitter=0.5, seed=3),
    dict(backoff_base_s=0.01, backoff_cap_s=1.0, jitter=0.9, seed=7),
])
def test_backoff_sequence_as_reference(kw):
    port, ref = RetryPolicy(**kw), j_faults.RetryPolicy(**kw)
    attempts = [1, 2, 3, 4, 5, 6, 7, 8, 1, 1, 2] * 4
    got = [port.backoff_s(k) for k in attempts]
    assert got == [ref.backoff_s(k) for k in attempts]
    if not kw["jitter"]:
        assert got[:4] == [0.1, 0.2, 0.35, 0.35]
    for bad in (dict(max_attempts=0), dict(jitter=1.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
        with pytest.raises(ValueError):
            j_faults.RetryPolicy(**bad)


def test_ladder_floor_follows_the_device():
    assert ladder_floor("cpu") == ladder_floor(torch.device("cpu")) \
        == DEGRADE_LADDER[-1] == "torch"
    assert ladder_floor("cuda") == ladder_floor(torch.device("cuda", 0)) \
        == faults.CUDA_FLOOR == "cuda_popcount"
    floor = ladder_floor("cuda")
    assert demote_mode("cuda_direct", floor) == "cuda_popcount"
    assert demote_mode("cuda_popcount", floor) is None
    # off-ladder modes demote straight to the card's floor
    assert demote_mode("cuda_pm1", floor) == demote_mode("auto", floor) \
        == "cuda_popcount"
    # a plain mode below the card's floor has no rung to demote to
    assert demote_mode("torch_pm1", floor) is None
    assert demote_mode("torch", floor) is None
    with pytest.raises(ValueError, match="floor"):
        BackendHealth("cuda_chain", floor="cuda_pm1")


@pytest.mark.parametrize("base", ["cuda_chain", "cuda_direct_pool",
                                  "cuda_pm1", "auto"])
def test_card_ladder_stops_at_the_hand_written_floor(base):
    """Failures without end on the card's ladder: every rung visited is a
    hand-written one, the ladder rests at ``cuda_popcount``, and probes
    never offer a mode below it."""
    for health in (BackendHealth(base, demote_after=1, probe_after_s=1.0,
                                 floor=ladder_floor("cuda")),
                   BucketHealth(base, demote_after=1, probe_after_s=1.0,
                                floor=ladder_floor("cuda")).ladder(4)):
        seen, t = [health.mode], 0.0
        for _ in range(12):
            t += 0.25
            if health.record_failure(t) is not None:
                seen.append(health.mode)
            probe = health.probe_due(t)
            if probe is not None:
                seen.append(probe)
                health.probe_failed(probe, t)
        assert health.mode == "cuda_popcount"
        assert not any(m.startswith("torch") for m in seen), seen
        want = (DEGRADE_LADDER[DEGRADE_LADDER.index(base):4]
                if base in DEGRADE_LADDER else (base, "cuda_popcount"))
        assert tuple(d["to_mode"] for d in health.demotions) == want[1:]


# --------------------------------------------------------------------------
# Backend and bucket health
# --------------------------------------------------------------------------

def _health_stream(n: int = 120):
    """A seeded stream of (op, bucket, time) health events."""
    rng = np.random.default_rng(5)
    t = 0.0
    for _ in range(n):
        t += float(rng.uniform(0.0, 4.0))
        op = str(rng.choice(["fail", "fail", "ok", "probe"]))
        yield op, int(rng.choice([1, 2, 8])), t


@pytest.mark.parametrize("base", ["cuda_chain", "cuda_direct",
                                  "torch_pm1", "cuda_pm1"])
def test_backend_health_as_reference(base):
    """One event stream through both packages' BackendHealth: the same
    modes after every event, the same demotion log and snapshots (port
    modes mapped through JAX_MODE; ``cuda_pm1`` is the reference's
    off-ladder ``mxu_pm1``)."""
    jbase = JAX_MODE[base]
    kw = dict(demote_after=2, probe_after_s=10.0, probe_backoff=2.0)
    port, ref = BackendHealth(base, **kw), j_faults.BackendHealth(jbase,
                                                                  **kw)
    for op, _, t in _health_stream():
        if op == "fail":
            got = port.record_failure(t)
            want = ref.record_failure(t)
            assert JAX_MODE.get(got, got) == want
        elif op == "ok":
            port.record_success()
            ref.record_success()
        else:
            probe = port.probe_due(t)
            assert JAX_MODE.get(probe, probe) == ref.probe_due(t)
            if probe is not None:
                if t % 2 < 1:
                    port.promote(probe)
                    ref.promote(JAX_MODE[probe])
                else:
                    port.probe_failed(probe, t)
                    ref.probe_failed(JAX_MODE[probe], t)
        assert JAX_MODE[port.mode] == ref.mode
        assert _map_modes(port.snapshot(t)) == ref.snapshot(t)
    assert port.demotions                      # the stream did demote
    assert _map_modes(port.demotions) == ref.demotions


def test_bucket_health_as_reference():
    kw = dict(demote_after=2, probe_after_s=10.0)
    port, ref = BucketHealth("cuda_chain", **kw), \
        j_faults.BucketHealth("vpu_chain", **kw)
    for op, b, t in _health_stream(200):
        if op == "fail":
            got = port.record_failure(b, t)
            assert JAX_MODE.get(got, got) == ref.record_failure(b, t)
        elif op == "ok":
            port.ladder(b)
            ref.ladder(b)
            port.record_success(b)
            ref.record_success(b)
        else:
            probe = port.probe_due(b, t)
            assert JAX_MODE.get(probe, probe) == ref.probe_due(b, t)
            if probe is not None:
                port.promote(b, probe)
                ref.promote(b, JAX_MODE[probe])
        assert JAX_MODE[port.mode] == ref.mode
        assert JAX_MODE[port.mode_for(b)] == ref.mode_for(b)
    assert _map_modes(port.snapshot(1e4)) == ref.snapshot(1e4)
    assert _map_modes(port.demotions) == ref.demotions
    assert {d["bucket"] for d in port.demotions} == {1, 2, 8}
