"""Replica-group serving: one front end over device-pinned replicas
(DESIGN.md §13.3).

Counterpart of ``repro.distributed.replicas``.  Data parallelism scales one
batch; a replica group scales request streams: N copies of the model, each
pinned to its own device (or its own pipeline of devices), behind one
object speaking the servers' protocol — ``submit`` / ``poll`` / ``step`` /
``drain`` / ``metrics``.

Each replica is a full :class:`~repro_torch.serving.server.InferenceServer`
lane over its own engine view, with its own scheduler, retry policy,
per-bucket ladder and flight recorder, so the resilience layer applies per
replica with no new code:

* a fault on one replica demotes and quarantines that replica's ladder
  only; the router steers new work to the healthy replicas while the sick
  one re-probes and promotes on the normal schedule;
* every lane is built with ``tenant=<replica name>``, so a fault plan
  targets one replica by matching ``{"tenant": "r1"}`` at
  ``server.dispatch`` / ``server.device``, and flight records carry the
  replica.

A replica is pinned through the pipeline placement: its lane gets a
:class:`~repro_torch.distributed.pipeline.Pipelined` over its device slice
(one stage, or ``devices_per_replica`` stages).  Engines are views
(``engine.view()``, :func:`dataclasses.replace` of the
:class:`~repro_torch.serving.engine.PhoneBitEngine`): the packed tensors
are shared, each view has its own executor and capture caches and its own
CUDA-graph pool, so two replicas on one card never share an output
buffer.

Routing prefers healthy replicas (not demoted, not slow), then the
shallowest queue, then round robin.  A
:class:`~repro_torch.distributed.straggler.StragglerMonitor` a replica
watches its step wall times; a persistently slow replica is routed around
like a demoted one until a step is not flagged.

:class:`LMReplicaGroup` does the same for continuous-batching LM lanes,
with checkpoint-backed migration of in-flight sequences between lanes.

The port has no trace counter: ``build_count`` and ``capture_count``
(summed over the replicas' engines) carry the reference's ``trace_count``
contract — flat while requests flow once ``compile_buckets`` ran.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

from repro_torch.distributed.pipeline import Pipelined
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.obs import trace as _trace
from repro_torch.serving.scheduler import Request
from repro_torch.serving.server import InferenceServer


class Replica:
    """One replica lane: its server, devices and straggler state."""

    __slots__ = ("name", "server", "devices", "monitor", "slow", "rr")

    def __init__(self, name: str, server: InferenceServer,
                 devices: tuple, monitor: StragglerMonitor):
        self.name = name
        self.server = server
        self.devices = devices
        self.monitor = monitor
        # Set by the monitor's persistent-outlier hook; cleared by the
        # next step it does not flag.
        self.slow = False
        self.rr = 0  # round-robin tiebreak stamp

    @property
    def healthy(self) -> bool:
        # Demoted: the lane's worst bucket sits below the engine's mode.
        h = self.server.health
        demoted = h is not None and h.mode != self.server.engine.matmul_mode
        return not demoted and not self.slow


class ReplicaGroup:
    """N device-pinned InferenceServer replicas behind one front end.

    ``devices_per_replica`` > 1 makes each replica a pipeline over that
    many devices (replicas of pipelines).  Keyword arguments become every
    lane's ``InferenceServer`` defaults; each lane gets ``tenant=<name>``
    and a ``Pipelined`` placement over its device slice."""

    def __init__(self, engine, devices: Sequence[Any], *,
                 devices_per_replica: int = 1,
                 names: Sequence[str] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] | None = None,
                 slow_after: int = 3,
                 **server_kw):
        devices = tuple(devices)
        k = int(devices_per_replica)
        if k < 1 or len(devices) < k:
            raise ValueError(f"devices_per_replica={k} needs at least "
                             f"{k} of {len(devices)} devices")
        if len(devices) % k:
            raise ValueError(f"{len(devices)} devices do not split into "
                             f"replicas of {k}")
        n = len(devices) // k
        names = tuple(names if names is not None
                      else (f"r{i}" for i in range(n)))
        if len(names) != n:
            raise ValueError(f"{len(names)} names for {n} replicas")
        self.clock = clock
        self._sleep = sleep if sleep is not None \
            else (lambda s: time.sleep(min(s, 0.05)))
        kw = dict(server_kw)
        kw.setdefault("clock", clock)
        self.replicas: dict[str, Replica] = {}
        self._rr = 0
        for i, name in enumerate(names):
            devs = devices[i * k:(i + 1) * k]
            server = InferenceServer(engine.view(), tenant=name,
                                     placement=Pipelined(devs), **kw)
            monitor = StragglerMonitor(persistent_after=slow_after)
            rep = Replica(name, server, devs, monitor)
            # A persistent outlier leaves the preferred pool; any clean
            # step brings it back (_observe_step).
            monitor.on_persistent = (
                lambda step, _r=rep: setattr(_r, "slow", True))
            self.replicas[name] = rep

    # ---- warm-up ----------------------------------------------------------
    def compile_buckets(self) -> dict[str, dict[int, float]]:
        """Build (and on the card capture) every replica's buckets on its
        devices; after this serving builds nothing group-wide."""
        return {name: rep.server.compile_buckets()
                for name, rep in self.replicas.items()}

    @property
    def build_count(self) -> int:
        return sum(r.server.engine.build_count
                   for r in self.replicas.values())

    @property
    def capture_count(self) -> int:
        return sum(r.server.engine.capture_count
                   for r in self.replicas.values())

    # ---- routing ----------------------------------------------------------
    def _route(self) -> Replica:
        """Health, then queue depth, then round robin."""
        reps = list(self.replicas.values())
        pool = [r for r in reps if r.healthy] or reps
        self._rr += 1
        chosen = min(pool, key=lambda r: (r.server.queue_depth, r.rr))
        chosen.rr = self._rr
        return chosen

    # ---- request lifecycle ------------------------------------------------
    def submit(self, payload: Any, replica: str | None = None,
               **kw) -> Request:
        """Route one request to a replica, or pin it with ``replica=``."""
        rep = self.replicas[replica] if replica is not None \
            else self._route()
        r = rep.server.submit(payload, **kw)
        _trace.instant("replica.route", "serve", req=r.id,
                       replica=rep.name)
        return r

    def poll(self, request: Request) -> bool:
        return request.done

    # ---- serving loop -----------------------------------------------------
    def _observe_step(self, rep: Replica, dt: float, step_no: int) -> None:
        flagged = rep.monitor.observe(step_no, dt)
        if not flagged and rep.slow:
            rep.slow = False    # caught up: back in the healthy pool

    def step(self, now: float | None = None,
             force: bool = False) -> list[Request]:
        """One tick of every replica, each timed by its monitor; returns
        the requests completed this tick."""
        done: list[Request] = []
        for rep in self.replicas.values():
            t = self.clock() if now is None else now
            t0 = time.perf_counter()
            done += rep.server.step(t, force=force)
            self._observe_step(rep, time.perf_counter() - t0,
                               rep.monitor._n)
        return done

    def _busy(self) -> bool:
        return any(len(r.server.scheduler) or r.server._pending is not None
                   for r in self.replicas.values())

    def drain(self, now: float | None = None,
              max_steps: int | None = None) -> list[Request]:
        """Serve until every replica is idle; bounded like
        ``InferenceServer.drain`` (what is left then resolves ``error``)."""
        if max_steps is None:
            budget = max([(r.server.retry.max_attempts if r.server.retry
                           else 1) for r in self.replicas.values()] or [1])
            queued = sum(len(r.server.scheduler)
                         for r in self.replicas.values())
            max_steps = 4 * (queued + 2 * max(len(self.replicas), 1)
                             + 2) * budget + 16
        done: list[Request] = []
        steps = 0
        while self._busy():
            if steps >= max_steps:
                t = self.clock() if now is None else now
                for rep in self.replicas.values():
                    done += rep.server._abort_wedged(t)
                break
            steps += 1
            t = self.clock() if now is None else now
            done += self.step(t, force=True)
            if all(r.server._pending is None
                   for r in self.replicas.values()):
                queued = [r for r in self.replicas.values()
                          if len(r.server.scheduler)]
                waits = [r.server.scheduler.backoff_wait(t)
                         for r in queued]
                if queued and all(w is not None and w > 0 for w in waits):
                    self._sleep(min(waits))
        return done

    # ---- observability ----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(r.server.queue_depth for r in self.replicas.values())

    def metrics(self) -> dict:
        """Each replica's server snapshot and the routing ledger (health,
        slow flag, mode, devices, mean step time)."""
        return {
            "replicas": {name: rep.server.metrics()
                         for name, rep in self.replicas.items()},
            "routing": {name: {
                "healthy": rep.healthy,
                "slow": rep.slow,
                "mode": (rep.server.health.mode
                         if rep.server.health is not None
                         else rep.server.engine.matmul_mode),
                "devices": [str(d) for d in rep.devices],
                "mean_step_s": round(rep.monitor.mean_step_time, 6),
            } for name, rep in self.replicas.items()},
            "queue_depth": self.queue_depth,
        }


# ---------------------------------------------------------------------------
# LM decode lanes with cross-lane sequence migration (DESIGN.md §14.4)
# ---------------------------------------------------------------------------

class LMLane:
    """One LM decode lane: its server and quarantine state.  A lane whose
    decode faults outlast its in-lane restore budget hands its flight away
    and sits out a doubling probe interval before routing sends it new
    work."""

    __slots__ = ("name", "server", "quarantined_until", "probe_interval",
                 "quarantines", "rr")

    def __init__(self, name: str, server, probe_after_s: float):
        self.name = name
        self.server = server
        self.quarantined_until: float | None = None
        self.probe_interval = probe_after_s
        self.quarantines = 0
        self.rr = 0

    def quarantined(self, now: float) -> bool:
        return (self.quarantined_until is not None
                and now < self.quarantined_until)


class LMReplicaGroup:
    """N continuous-batching LM lanes behind one front end, with
    checkpoint-backed sequence migration (DESIGN.md §14.4).

    Each lane is a :class:`~repro_torch.serving.lm_server.LMServer`
    (``tenant=<name>``, so a plan targets one lane by matching
    ``{"tenant": "lm1"}`` at ``lm.step``) over the one ``params`` dict —
    the weights are never copied a lane — with its own KV cache and, on the
    card, its own captured decode step.  The group is every lane's
    ``evacuate`` hook: when a lane's decode faults outlast its restore
    budget, its in-flight sequences (prompt and every emitted token, kept
    host side) are adopted by a healthy lane through a replay prefill
    (``LMServer.adopt_sequence``).  Migration keeps the emitted prefix
    verbatim but is not bit for bit: positions and cache history differ
    across lanes.  The evacuated lane is quarantined with a doubling probe
    interval.

    ``rules``: every lane's ``LMServer(rules=)``, sharded over the mesh
    (``None``: one device).  Every rank builds every lane
    and makes the same calls, so the group reads rank 0's clock, as each
    lane does: routing, quarantine and the evacuation target come out the
    same on every rank.  Keyword arguments become every lane's
    ``LMServer`` defaults (``device=`` included)."""

    def __init__(self, cfg, rules, params, *, n_slots: int, max_seq: int,
                 n_lanes: int = 2, names: Sequence[str] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 probe_after_s: float = 30.0, probe_backoff: float = 2.0,
                 **lane_kw):
        from repro_torch.serving.lm_server import LMServer, _RankZeroClock

        names = tuple(names if names is not None
                      else (f"lm{i}" for i in range(n_lanes)))
        self.clock = clock
        if rules is not None and rules.n_devices > 1:
            self.clock = _RankZeroClock(
                clock, rules.comm(tuple(rules.mesh.axis_names)),
                rules.device)
        self.probe_backoff = probe_backoff
        self.migrations = 0     # sequences adopted across lanes
        self._rr = 0
        kw = dict(lane_kw)
        kw.setdefault("clock", clock)       # each lane reads rank 0's
        kw.setdefault("checkpoint_every", 4)
        self.lanes: dict[str, LMLane] = {}
        for name in names:
            server = LMServer(cfg=cfg, rules=rules, params=params,
                              n_slots=n_slots, max_seq=max_seq,
                              tenant=name, **kw)
            lane = LMLane(name, server, probe_after_s)
            server.evacuate = (
                lambda items, _lane=lane: self._adopt(_lane, items))
            self.lanes[name] = lane

    # ---- migration --------------------------------------------------------
    def _adopt(self, origin: LMLane, items: list) -> bool:
        """One lane's evacuation hook: a healthy lane with room for the
        whole flight replay-prefills every sequence, and the origin is
        quarantined.  All or nothing."""
        now = self.clock()
        candidates = sorted(
            (ln for ln in self.lanes.values()
             if ln is not origin and not ln.quarantined(now)),
            key=lambda ln: (ln.server.queue_depth, ln.rr))
        target = next(
            (ln for ln in candidates
             if len(ln.server.manager._free) >= len(items)), None)
        if target is None:
            return False
        t0 = time.perf_counter()
        for r, seq in items:
            target.server.adopt_sequence(r, seq.prompt, seq.tokens,
                                         seq.max_new)
        adopt_s = time.perf_counter() - t0
        origin.quarantined_until = now + origin.probe_interval
        origin.probe_interval *= self.probe_backoff
        origin.quarantines += 1
        self.migrations += len(items)
        _trace.instant("replica.migrate", "serve", n=len(items),
                       src=origin.name, dst=target.name)
        target.server.flight.record(kind="migration", outcome="adopted",
                                    seqs=len(items), src=origin.name,
                                    adopt_s=adopt_s, done_s=now)
        return True

    # ---- routing ----------------------------------------------------------
    def _route(self, now: float) -> LMLane:
        lanes = list(self.lanes.values())
        pool = [ln for ln in lanes if not ln.quarantined(now)] or lanes
        self._rr += 1
        chosen = min(pool, key=lambda ln: (ln.server.queue_depth, ln.rr))
        chosen.rr = self._rr
        return chosen

    # ---- request lifecycle ------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 16,
               lane: str | None = None, **kw) -> Request:
        now = self.clock()
        ln = self.lanes[lane] if lane is not None else self._route(now)
        r = ln.server.submit(prompt, max_new=max_new, **kw)
        _trace.instant("replica.route", "serve", req=r.id, lane=ln.name)
        return r

    def poll(self, request: Request) -> bool:
        return request.done

    # ---- serving loop -----------------------------------------------------
    def serve_tick(self, now: float | None = None) -> list[Request]:
        done: list[Request] = []
        for ln in self.lanes.values():
            done += ln.server.serve_tick(now)
        return done

    def _busy(self) -> bool:
        return any(ln.server.queue_depth for ln in self.lanes.values())

    def drain(self, now: float | None = None,
              max_steps: int | None = None) -> list[Request]:
        """Serve until every lane is idle; bounded like ``LMServer.drain``
        (a wedged lane's requests resolve ``error``)."""
        if max_steps is None:
            budget = max((ln.server.retry.max_attempts
                          if ln.server.retry else 1)
                         for ln in self.lanes.values())
            outstanding = sum(ln.server.queue_depth
                              for ln in self.lanes.values()) + 1
            max_seq = max(ln.server.max_seq for ln in self.lanes.values())
            max_steps = outstanding * (max_seq + budget) * 2 + 16
        done: list[Request] = []
        steps = 0
        while self._busy():
            if steps >= max_steps:
                for ln in self.lanes.values():
                    done += ln.server.drain(now=now, max_steps=0)
                break
            steps += 1
            done += self.serve_tick(now)
        return done

    # ---- observability ----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(ln.server.queue_depth for ln in self.lanes.values())

    def metrics(self) -> dict:
        now = self.clock()
        return {
            "lanes": {name: ln.server.metrics()
                      for name, ln in self.lanes.items()},
            "routing": {name: {
                "quarantined": ln.quarantined(now),
                "quarantines": ln.quarantines,
                "restores": ln.server.restores,
                "evacuations": ln.server.evacuations,
            } for name, ln in self.lanes.items()},
            "migrations": self.migrations,
            "queue_depth": self.queue_depth,
        }
