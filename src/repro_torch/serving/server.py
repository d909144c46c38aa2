"""InferenceServer: batched image serving over a PhoneBitEngine (DESIGN.md §7).

Counterpart of ``repro.serving.server`` for the serving core:

* a :class:`~repro_torch.serving.scheduler.BatchScheduler` assembling
  deadline-aware, bucket-padded batches;
* the engine's per-bucket executor cache — ``compile_buckets()`` builds
  one executor per bucket up front, so serving builds nothing.  On the
  card each bucket is one captured CUDA graph (``capture=False`` serves
  the eager executors, for debugging); a batch is staged straight into
  the bucket's static input, the counterpart of the reference's donated
  input buffer, and ``artifact=`` restores the buckets from an
  :func:`~repro_torch.serving.artifact.export_artifact` directory at
  construction (``artifact_report``);
* async dispatch: torch launches return before the device finishes.  A
  batch's replay (or kernels) is queued, then the copy of its output into
  pinned host memory, then an event, all on one stream, so the copy is
  queued before the next replay can overwrite the graph's output;
  ``step()`` queues batch k+1 before it waits on batch k's event (the one
  blocking point), so the device works on k+1 while the host scatters k;
* multi-tenant lanes (:mod:`repro_torch.serving.multiplex`): ``tenant=``
  stamps flight records and ``metrics()``, ``dispatched_rows`` counts the
  padded rows dispatched (the fair-share charge), and
  ``step(dispatch=False)`` runs the housekeeping half only;
* ``metrics()``: p50/p95 latency, served, dropped, queue depth, throughput;
* ``flight``: a :class:`~repro_torch.obs.flight.FlightRecorder` of the
  last requests (served, shed, rejected, error) with their arrival,
  bucket and stage timings;
* trace spans on the reference's sites (``compile.bucket``,
  ``serve.assemble``, ``serve.stage``, ``serve.dispatch``,
  ``serve.device``, ``serve.scatter``; instants ``serve.submit``,
  ``serve.reject``, ``serve.shed``, ``serve.error``): with tracing off a
  site costs one global read, and on it adds host-side spans only, so
  served rows are bit-exact either way.

The ``preprocess=`` hook runs per payload before a batch is staged; the
workloads' hook returns a tensor on the engine's device, so on the card
the resize runs there.

Every request resolves: ``submit`` checks each payload as the reference's
validator does (array-like, numeric, finite, and the engine's input shape
when there is no preprocess hook) and resolves a bad one ``rejected``
alone; a batch whose preprocess, dispatch or readback still raises
resolves each of its rows ``error``, and serving goes on.  Fault
injection, retry and degradation ladders, the request journal and
placement are not ported.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.obs import trace as _trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import ServingMetrics
from repro_torch.runtime.executor import CapturedExecutor
from repro_torch.serving.scheduler import BatchScheduler, Request


class _InFlight:
    """One dispatched batch: its requests, the host tensor its output is
    being copied into, the event that marks the copy done (None on the
    CPU, where the work is already done), its bucket, when its dispatch
    returned and how long staging and dispatch took."""

    __slots__ = ("batch", "host", "event", "bucket", "t_dispatch",
                 "stage_s")

    def __init__(self, batch: list[Request], host: torch.Tensor,
                 event: torch.cuda.Event | None, bucket: int,
                 t_dispatch: float, stage_s: float):
        self.batch = batch
        self.host = host
        self.event = event
        self.bucket = bucket
        self.t_dispatch = t_dispatch
        self.stage_s = stage_s


class InferenceServer:
    """Batched image-inference front end.

    engine:          anything with ``compile(bs, capture=) -> callable``,
                     ``_plan_shape``, ``device`` and ``matmul_mode`` (a
                     :class:`PhoneBitEngine` or a ``WorkloadEngine``).
    buckets:         batch sizes the engine is compiled for; mixed-size
                     traffic is zero-padded up to the nearest one.
    preprocess:      optional per-payload transform: payload in,
                     network-size uint8 image out (numpy or a tensor on
                     any device; the batch is moved to the engine's).
    clock:           injectable monotonic clock.
    tenant:          optional tenant name stamped onto flight records and
                     ``metrics()`` (how a multiplexer labels its lanes).
    artifact:        optional :func:`~repro_torch.serving.artifact.
                     export_artifact` directory: the buckets are restored
                     (and captured on the card) at construction with no
                     tuning, planning or building; a bucket whose
                     environment differs takes the live compile path.
    capture:         the engine's ``compile(capture=)``: None captures
                     each bucket on the card; False serves eagerly.
    """

    def __init__(self, engine, *, max_batch: int = 8,
                 max_wait_s: float = 0.0,
                 buckets: tuple[int, ...] = (1, 2, 4, 8),
                 preprocess: Callable[[np.ndarray], Any] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 tenant: str | None = None, artifact: str | None = None,
                 capture: bool | None = None):
        self.engine = engine
        self.preprocess = preprocess
        self.scheduler = BatchScheduler(max_batch=max_batch,
                                        max_wait_s=max_wait_s,
                                        buckets=tuple(buckets))
        self.clock = clock
        self.tenant = tenant
        self.capture = capture
        self._pending: _InFlight | None = None
        self._metrics = ServingMetrics(clock)
        self.flight = FlightRecorder(
            tags={"tenant": tenant} if tenant is not None else None)
        # Padded bucket rows dispatched since construction (what the card
        # paid for): the cost a multiplexer charges each tenant's vtime.
        self.dispatched_rows = 0
        self.artifact_report: dict | None = None
        if artifact is not None:
            self.artifact_report = engine.load_artifact(
                artifact, buckets=tuple(self.scheduler.buckets),
                capture=capture)

    # ---- executor cache ---------------------------------------------------
    def compile_buckets(self) -> dict[int, float]:
        """Build (and run once) every bucket's executor; returns seconds
        per bucket.  After this, serving builds nothing (``build_count``
        stays flat)."""
        timings: dict[int, float] = {}
        for b in self.scheduler.buckets:
            with _trace.span("compile.bucket", "compile", bucket=b):
                t0 = time.perf_counter()
                exe = self.engine.compile(b, capture=self.capture)
                x = torch.zeros(self.engine._plan_shape(b),
                                dtype=torch.uint8, device=self.engine.device)
                exe(x)
                if self.engine.device.type == "cuda":
                    torch.cuda.synchronize(self.engine.device)
                timings[b] = time.perf_counter() - t0
        return timings

    # ---- request lifecycle ------------------------------------------------
    def submit(self, payload: Any, deadline_s: float | None = None,
               now: float | None = None) -> Request:
        # Arrival is stamped from the server's clock so latency samples
        # stay in one clock domain when a fake clock is injected.
        now = self.clock() if now is None else now
        err = self._payload_error(payload)
        if err is not None:
            r = Request(payload, deadline_s=deadline_s)
            r.arrival_s = now
            r.resolve("rejected", error=err)
            self._metrics.record_rejected()
            self.flight.record(id=r.id, outcome="rejected", error=err,
                               arrival_s=now, done_s=now, latency_s=0.0)
            _trace.instant("serve.reject", "serve", req=r.id, reason=err)
            return r
        r = self.scheduler.submit(payload, deadline_s=deadline_s, now=now)
        _trace.instant("serve.submit", "serve", req=r.id)
        return r

    def _payload_error(self, payload: Any) -> str | None:
        """Why this payload cannot be served, or None when it can: checked
        at the protocol edge, so a malformed payload resolves alone
        instead of failing the batch it would have ridden in."""
        try:
            arr = np.asarray(payload)
        except Exception as e:          # noqa: BLE001 — any failure rejects
            return f"payload is not array-like: {e}"
        if not np.issubdtype(arr.dtype, np.number):
            return f"payload dtype {arr.dtype} is not numeric"
        if np.issubdtype(arr.dtype, np.floating) \
                and not bool(np.isfinite(arr).all()):
            return "payload contains NaN/Inf"
        if self.preprocess is None:
            want = tuple(self.engine._plan_shape(1)[1:])
            if tuple(arr.shape) != want:
                return (f"payload shape {tuple(arr.shape)} != engine "
                        f"input {want}")
        return None

    def _fail(self, batch: list[Request], e: Exception) -> list[Request]:
        now = self.clock()
        for r in batch:
            r.resolve("error", error=f"batch failed: {e!r}")
            self.flight.record(id=r.id, outcome="error", error=r.error,
                               arrival_s=r.arrival_s,
                               deadline_s=r.deadline_s, done_s=now,
                               latency_s=now - r.arrival_s)
            _trace.instant("serve.error", "serve", req=r.id)
        self._metrics.record_error(len(batch))
        return batch

    def poll(self, request: Request) -> bool:
        return request.done

    # ---- dispatch / scatter ----------------------------------------------
    def _stage(self, payloads: list[Any], exe) -> torch.Tensor:
        """The batch as one tensor: for a captured bucket, written straight
        into its static input (a host batch through pinned memory).  Rows
        of another shape or dtype than that input raise, as the eager
        path's K4 refuses them: a copy would cast them silently."""
        if self.preprocess is not None:
            rows = [torch.as_tensor(self.preprocess(np.asarray(p)))
                    for p in payloads]
        else:
            rows = [torch.from_numpy(np.asarray(p)) for p in payloads]
        if not isinstance(exe, CapturedExecutor):
            return torch.stack(rows)
        dst = exe.static_input
        if tuple(rows[0].shape) != tuple(dst.shape[1:]) \
                or rows[0].dtype != dst.dtype:
            raise ValueError(f"staged rows {tuple(rows[0].shape)} "
                             f"{rows[0].dtype} do not fit the bucket's "
                             f"input {tuple(dst.shape)} {dst.dtype}")
        if rows[0].device == dst.device:
            torch.stack(rows, out=dst)
        elif rows[0].is_cuda:
            dst.copy_(torch.stack(rows))
        else:
            dst.copy_(torch.stack(rows).pin_memory(), non_blocking=True)
        return dst

    def _dispatch(self, batch: list[Request],
                  payloads: list[Any]) -> _InFlight:
        t0 = self.clock()
        bucket = len(payloads)
        exe = self.engine.compile(bucket, capture=self.capture)
        with _trace.span("serve.stage", "serve", bucket=bucket,
                         n_real=len(batch)):
            x = self._stage(payloads, exe)
        with _trace.span("serve.dispatch", "serve", bucket=bucket):
            self._metrics.mark_dispatch(bucket=bucket)
            if self.engine.device.type != "cuda":
                host, event = exe(x.to(self.engine.device)), None
            else:
                if isinstance(exe, CapturedExecutor):
                    out = exe.replay()                # queued: returns now
                else:
                    if not x.is_cuda:                 # a host batch
                        x = x.pin_memory().to(self.engine.device,
                                              non_blocking=True)
                    out = exe(x)
                # Queued on the replay's stream, so before the next replay
                # can overwrite the graph's output.
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
        self.dispatched_rows += bucket
        t1 = self.clock()
        return _InFlight(batch, host, event, bucket, t1, t1 - t0)

    def _scatter(self, flight: _InFlight) -> list[Request]:
        with _trace.span("serve.device", "serve", bucket=flight.bucket):
            if flight.event is not None:
                flight.event.synchronize()            # the one blocking point
            host = flight.host.numpy()
        now = self.clock()
        with _trace.span("serve.scatter", "serve",
                         n_real=len(flight.batch)):
            for i, r in enumerate(flight.batch):
                r.resolve("served", host[i])
        self._metrics.record([now - r.arrival_s for r in flight.batch])
        for r in flight.batch:
            self.flight.record(
                id=r.id, outcome="served", bucket=flight.bucket,
                arrival_s=r.arrival_s, deadline_s=r.deadline_s,
                dispatched_s=flight.t_dispatch, done_s=now,
                queue_s=flight.t_dispatch - r.arrival_s,
                stage_s=flight.stage_s, latency_s=now - r.arrival_s,
                mode=self.engine.matmul_mode)
        return flight.batch

    def _record_shed(self, shed: list[Request], now: float) -> None:
        self._metrics.record_dropped(len(shed))
        for r in shed:
            self.flight.record(id=r.id, outcome="shed",
                               arrival_s=r.arrival_s,
                               deadline_s=r.deadline_s, done_s=now,
                               latency_s=now - r.arrival_s)
            _trace.instant("serve.shed", "serve", req=r.id)

    def step(self, now: float | None = None, force: bool = False,
             dispatch: bool = True) -> list[Request]:
        """One serving tick: dispatch the next batch (policy permitting),
        then scatter the previously in-flight one.  Returns the requests
        completed this tick.  ``dispatch=False`` runs the housekeeping
        half only — shed expired requests, scatter the in-flight batch —
        as a multiplexer does on the lanes it did not pick."""
        now = self.clock() if now is None else now
        # Shed before assembly, so the flight recorder sees every deadline
        # outcome (padded_batch sheds too, at the same ``now``: nothing is
        # left for it to shed).
        shed = self.scheduler.shed_expired(now)
        if shed:
            self._record_shed(shed, now)
        flight = None
        done: list[Request] = []
        got = None
        if dispatch:
            with _trace.span("serve.assemble", "serve"):
                got = self.scheduler.padded_batch(now, force=force)
        if got is not None:
            try:
                flight = self._dispatch(*got)
            except Exception as e:       # noqa: BLE001 — nothing escapes
                done += self._fail(got[0], e)
        pending, self._pending = self._pending, flight
        if pending is not None:
            try:
                done += self._scatter(pending)
            except Exception as e:       # noqa: BLE001
                done += self._fail(pending.batch, e)
        return done

    def drain(self, now: float | None = None) -> list[Request]:
        """Serve until the queue is empty and nothing is in flight (the
        batch-wait policy is skipped: drain is a flush)."""
        done: list[Request] = []
        while len(self.scheduler) or self._pending is not None:
            done += self.step(now, force=True)
        return done

    # ---- observability ----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        inflight = len(self._pending.batch) if self._pending else 0
        return len(self.scheduler) + inflight

    def metrics(self) -> dict:
        """p50/p95 request latency (submit→scatter, ms), served/dropped
        counts, live queue depth, and throughput over the busy window
        (first dispatch → last scatter)."""
        extra = {"tenant": self.tenant} if self.tenant is not None else {}
        return self._metrics.snapshot(
            dropped=self.scheduler.dropped, queue_depth=self.queue_depth,
            mode=self.engine.matmul_mode,
            buckets=list(self.scheduler.buckets), **extra)
