"""Multi-tenant workload multiplexing (DESIGN.md §12).

Counterpart of ``repro.serving.multiplex``.  One front end serving several
models (AlexNet + VGG16 + YOLOv2-Tiny behind one process) without letting
any tenant starve or poison the others.  Each tenant gets a full
:class:`~repro_torch.serving.server.InferenceServer` **lane** — its own
scheduler, bucket executors (captured graphs on the card), retry policy,
per-bucket degradation ladders and flight recorder — and
:class:`MultiTenantServer` arbitrates which lane may *dispatch* each tick.
Composition gives the isolation:

* **degradation isolation** — a demotion of one model's bucket lives in
  that lane's ``BucketHealth`` and cannot demote another lane;
* **per-tenant observability** — every lane's metrics snapshot, flight
  records and fault contexts carry its tenant name
  (``InferenceServer(tenant=...)``);
* **failure isolation** — a faulted batch retries or errors inside its
  lane: the arbiter never sees the exception.

Admission across lanes is **strict priority, then weighted-fair**:

* lanes with a higher ``priority`` class always dispatch first (a
  saturated high-priority lane can starve lower classes — that is the
  contract);
* within a class, lanes are served by smallest virtual time, charged
  ``dispatched_rows / weight`` per dispatch (padded bucket rows — what
  the card actually paid for), so device rows split by ``weight`` under
  saturation whatever the request sizes or bucket shapes;
* a lane waking from idle has its vtime caught up to the arbiter's
  clock, so an idle tenant banks no credit it could later burst with.

Lanes not chosen still run their housekeeping half each tick
(``step(dispatch=False)``): shedding expired requests and retiring the
in-flight batch never wait on winning admission.  A lane whose whole
queue is in retry backoff is not ready: it would win, dispatch nothing,
never be charged and win every later tick.  When every queued lane is
starved by backoff alone, ``drain`` waits out the soonest through the
injectable ``sleep``, and its step bound counts the lanes' retry budget.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from repro_torch.serving.scheduler import Request
from repro_torch.serving.server import InferenceServer


class TenantLane:
    """One tenant behind the arbiter: its server plus fairness state."""

    __slots__ = ("name", "server", "weight", "priority", "vtime")

    def __init__(self, name: str, server: InferenceServer, weight: float,
                 priority: int, vtime: float):
        self.name = name
        self.server = server
        self.weight = weight
        self.priority = priority
        # Virtual time: cumulative dispatched rows / weight.  The lane
        # with the smallest vtime in the top priority class dispatches.
        self.vtime = vtime


class MultiTenantServer:
    """Weighted-fair multiplexer over per-tenant InferenceServer lanes.

    Speaks the single server's ``submit`` / ``poll`` / ``step`` /
    ``drain`` / ``metrics`` protocol, with ``submit`` taking the tenant
    name first.  Keyword arguments to the constructor become defaults for
    every lane's ``InferenceServer`` (per-tenant kwargs to
    :meth:`add_tenant` override them — ``artifact=`` among them, for a
    lane restored from an artifact).
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] | None = None,
                 **default_server_kw):
        self.clock = clock
        self._sleep = sleep if sleep is not None \
            else (lambda s: time.sleep(min(s, 0.05)))
        self._default_kw = dict(default_server_kw)
        self.lanes: dict[str, TenantLane] = {}
        # Arbiter virtual clock: the largest vtime ever charged.  Lanes
        # waking from idle catch up to it (no banked credit).
        self._v = 0.0

    # ---- tenant registration ---------------------------------------------
    def add_tenant(self, name: str, engine, *, weight: float = 1.0,
                   priority: int = 0, **server_kw) -> InferenceServer:
        """Register a tenant: builds its lane's ``InferenceServer`` over
        ``engine`` (higher ``priority`` = served first; ``weight`` sets
        the fair share within a priority class)."""
        if name in self.lanes:
            raise ValueError(f"tenant {name!r} already registered")
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        kw = {**self._default_kw, **server_kw}
        kw.setdefault("clock", self.clock)
        server = InferenceServer(engine, tenant=name, **kw)
        self.lanes[name] = TenantLane(name, server, float(weight),
                                      int(priority), self._v)
        return server

    def add_workload(self, name: str, workload, **kw) -> InferenceServer:
        """Register a :class:`~repro_torch.workloads.workload.Workload` as
        a tenant (its preprocess hook and WorkloadEngine)."""
        kw.setdefault("preprocess", workload.preprocess_hook)
        return self.add_tenant(name, workload.engine, **kw)

    def _lane(self, tenant: str) -> TenantLane:
        if tenant not in self.lanes:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"have {sorted(self.lanes)}")
        return self.lanes[tenant]

    def server(self, tenant: str) -> InferenceServer:
        return self._lane(tenant).server

    # ---- request lifecycle ------------------------------------------------
    def submit(self, tenant: str, payload: Any, **kw) -> Request:
        lane = self._lane(tenant)
        srv = lane.server
        if not len(srv.scheduler) and srv._pending is None:
            # Idle-lane catch-up: competing starts from the arbiter's
            # clock, not from vtime banked while the lane had no work.
            lane.vtime = max(lane.vtime, self._v)
        return srv.submit(payload, **kw)

    def poll(self, request: Request) -> bool:
        return request.done

    # ---- arbitration ------------------------------------------------------
    def _pick(self, now: float) -> TenantLane | None:
        """The lane allowed to dispatch this tick: top priority class,
        then smallest vtime (name-ordered tiebreak for determinism), among
        lanes with a request out of retry backoff."""
        def eligible(l: TenantLane) -> bool:
            if not len(l.server.scheduler):
                return False
            wait = l.server.scheduler.backoff_wait(now)
            return wait is None or wait <= 0

        ready = [l for l in self.lanes.values() if eligible(l)]
        if not ready:
            return None
        top = max(l.priority for l in ready)
        return min((l for l in ready if l.priority == top),
                   key=lambda l: (l.vtime, l.name))

    def step(self, now: float | None = None,
             force: bool = False) -> list[Request]:
        """One multiplexed tick: the arbitration winner runs a full
        serving step (and is charged for what it dispatched); every other
        lane runs housekeeping only.  Returns all requests completed this
        tick, across lanes."""
        now = self.clock() if now is None else now
        chosen = self._pick(now)
        done: list[Request] = []
        for lane in self.lanes.values():
            if lane is chosen:
                before = lane.server.dispatched_rows
                done += lane.server.step(now, force=force)
                delta = lane.server.dispatched_rows - before
                if delta:
                    lane.vtime += delta / lane.weight
                    self._v = max(self._v, lane.vtime)
            else:
                done += lane.server.step(now, dispatch=False)
        return done

    def _busy(self) -> bool:
        return any(len(l.server.scheduler) or l.server._pending is not None
                   for l in self.lanes.values())

    def drain(self, now: float | None = None,
              max_steps: int | None = None) -> list[Request]:
        """Serve until every lane's queue is empty and nothing is in
        flight (the batch-wait policy is skipped: drain is a flush).
        Bounded as ``InferenceServer.drain`` is: past ``max_steps`` (by
        default generous for the queues and the largest retry budget)
        each lane resolves its stragglers ``error``."""
        if max_steps is None:
            budget = max([(l.server.retry.max_attempts if l.server.retry
                           else 1) for l in self.lanes.values()] or [1])
            queued = sum(len(l.server.scheduler)
                         for l in self.lanes.values())
            max_steps = 4 * (queued + 2 * max(len(self.lanes), 1) + 2) \
                * budget + 16
        done: list[Request] = []
        steps = 0
        while self._busy():
            if steps >= max_steps:
                t = self.clock() if now is None else now
                for lane in self.lanes.values():
                    done += lane.server._abort_wedged(t)
                break
            steps += 1
            t = self.clock() if now is None else now
            done += self.step(t, force=True)
            if all(l.server._pending is None for l in self.lanes.values()):
                # Starved by retry backoff alone: wait out the soonest.
                waits = [l.server.scheduler.backoff_wait(t)
                         for l in self.lanes.values()
                         if len(l.server.scheduler)]
                if waits and all(w is not None and w > 0 for w in waits):
                    self._sleep(min(waits))
        return done

    # ---- observability ----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(l.server.queue_depth for l in self.lanes.values())

    def metrics(self) -> dict:
        """Per-tenant ``InferenceServer`` snapshots plus the fairness
        ledger (weight / priority / vtime / device rows dispatched)."""
        return {
            "tenants": {name: lane.server.metrics()
                        for name, lane in self.lanes.items()},
            "fairness": {name: {"weight": lane.weight,
                                "priority": lane.priority,
                                "vtime": round(lane.vtime, 6),
                                "dispatched_rows":
                                    lane.server.dispatched_rows}
                         for name, lane in self.lanes.items()},
            "queue_depth": self.queue_depth,
        }
