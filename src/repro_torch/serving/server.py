"""InferenceServer: batched image serving over a PhoneBitEngine (DESIGN.md §7,
§11).

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
  blocking point), so the device works on k+1 while the host scatters k.
  ``async_dispatch=False`` is the blocking baseline: a batch is scattered
  in the step that dispatched it (the watchdog bounds the same readback);
* multi-tenant lanes (:mod:`repro_torch.serving.multiplex`): ``tenant=``
  stamps flight records, fault contexts and ``metrics()``,
  ``dispatched_rows`` counts the padded rows dispatched (the fair-share
  charge), and ``step(dispatch=False)`` runs the housekeeping half only;
* ``metrics()``: p50/p95 latency, served, dropped, queue depth,
  throughput, the resilience counters and each bucket's ladder;
* ``flight``: a :class:`~repro_torch.obs.flight.FlightRecorder` of the
  last requests (served, shed, rejected, error) and of demotions and
  promotions;
* trace spans on the reference's sites (``compile.bucket``,
  ``serve.assemble``, ``serve.stage``, ``serve.dispatch``,
  ``serve.device``, ``serve.scatter``; instants ``serve.submit``,
  ``serve.reject``, ``serve.shed``, ``serve.retry``, ``serve.error``,
  ``serve.demote``, ``serve.promote``): with tracing off a site costs one
  global read, and on it adds host-side spans only, so served rows are
  bit-exact either way.

The ``preprocess=`` hook runs per payload at staging; the workloads' hook
returns a tensor on the engine's device, so on the card the resize runs
there.

Resilience, as the reference's: every request **terminally resolves** —
``done=True`` with ``outcome`` in {served, shed, error, rejected} — and
no failure escapes ``step()``:

* ``submit`` checks each payload as the reference's validator does
  (array-like, numeric, finite, and the engine's input shape when there
  is no preprocess hook) and applies bounded admission (``max_queue``),
  resolving a bad or excess one ``rejected`` alone;
* a row whose preprocess raises (or that does not fit the bucket's input)
  is zero-filled in the staged batch and fails alone; the other rows
  still dispatch;
* a failed batch (an ``engine.compile`` or capture error, a dispatch or
  replay fault, a readback fault) retries each request with capped
  exponential backoff and jitter (:class:`~repro_torch.serving.faults.
  RetryPolicy`) on the server's injectable clock, and resolves ``error``
  when its attempts are spent;
* consecutive failures of one bucket demote that bucket down
  :data:`~repro_torch.serving.faults.DEGRADE_LADDER` (``cuda_chain`` to
  ``cuda_direct_pool`` ...) through its own
  :class:`~repro_torch.serving.faults.BackendHealth`; the demoted rung's
  executor is built, and on the card captured, at that bucket's next
  dispatch into the engine's one graph pool; the failed mode is
  quarantined and re-probed after ``probe_after_s``.  The ladder's floor
  is the engine device's (:func:`~repro_torch.serving.faults.
  ladder_floor`): ``torch`` on the CPU, the hand-written
  ``cuda_popcount`` on the card, where a bucket failing at its floor
  resolves ``error`` after its retries and never reaches a plain
  PyTorch rung;
* ``watchdog_s`` bounds the readback in a reader thread, so a stalled
  batch surfaces as :class:`~repro_torch.serving.faults.WatchdogTimeout`
  (its pinned host buffer, one a dispatch, is dropped, never reused), and
  ``drain`` is step-bounded;
* ``journal=`` (:class:`~repro_torch.serving.recovery.RequestJournal`)
  journals each accepted submit before it enters the scheduler and each
  terminal outcome, so a fresh process replays what a crash left open.

Placement (DESIGN.md §13): ``placement=`` takes a placement object,
duck-typed on ``.kind`` so this module never imports
:mod:`repro_torch.distributed`.  ``kind == "pipeline"``
(:class:`~repro_torch.distributed.pipeline.Pipelined`) builds every bucket
through ``engine.compile(..., pipeline=devices)`` as a staged executor,
captured one graph a stage on the card; ``kind == "data"``
(:class:`~repro_torch.distributed.sharding.DataParallel`) rounds the
buckets up to a multiple of its shard count, as the reference does, and
builds each through ``engine.compile(..., data_parallel=devices)``: one
row shard a device, rows gathered on the first.  The reference's
``mesh=`` (a jax mesh and its data axis) has no counterpart: the port's
meshes (``launch.mesh``) run one process a rank, and the image server
names its devices through ``DataParallel`` instead.  The failure
protocol applies to a placed server unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.obs import inject as _inject
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import ServingMetrics
from repro_torch.runtime import executor as _executor
from repro_torch.serving.faults import (BucketHealth, RetryPolicy,
                                        WatchdogTimeout, ladder_floor)
from repro_torch.serving.scheduler import BatchScheduler, Request


@runtime_checkable
class Server(Protocol):
    """What a serving front end looks like, image or LM (the
    reference's)."""

    def submit(self, payload: Any, **kw) -> Request: ...

    def poll(self, request: Request) -> bool: ...

    def drain(self) -> list[Request]: ...

    def metrics(self) -> dict: ...


class _InFlight:
    """One dispatched batch: its requests, the row of the output each
    request reads (a row whose staging failed is zero-filled and skipped),
    the host tensor its output is being copied into, the event that marks
    the copy done (None on the CPU, where the work is already done), its
    bucket, when its dispatch returned, how long staging and dispatch
    took, the mode it ran under and whether it probes a quarantined
    mode."""

    __slots__ = ("batch", "row_idx", "host", "event", "bucket",
                 "t_dispatch", "stage_s", "mode", "probing")

    def __init__(self, batch: list[Request], row_idx: list[int],
                 host: torch.Tensor, event: torch.cuda.Event | None,
                 bucket: int, t_dispatch: float, stage_s: float,
                 mode: str, probing: bool = False):
        self.batch = batch
        self.row_idx = row_idx
        self.host = host
        self.event = event
        self.bucket = bucket
        self.t_dispatch = t_dispatch
        self.stage_s = stage_s
        self.mode = mode
        self.probing = probing


class InferenceServer:
    """Batched image-inference front end.

    engine:          anything with ``compile(bs, mode=, capture=) ->
                     callable``, ``_plan_shape``, ``device`` and
                     ``matmul_mode`` (a :class:`PhoneBitEngine` or a
                     ``WorkloadEngine``).
    buckets:         batch sizes the engine is compiled for; mixed-size
                     traffic is zero-padded up to the nearest one.
    preprocess:      optional per-payload transform: payload in,
                     network-size uint8 image out (numpy or a tensor on
                     any device; the batch is moved to the engine's).
    clock:           injectable monotonic clock.
    tenant:          optional tenant name stamped onto flight records,
                     fault contexts and ``metrics()`` (how a multiplexer
                     labels its lanes).
    artifact:        optional :func:`~repro_torch.serving.artifact.
                     export_artifact` directory: the buckets are restored
                     (and captured on the card) at construction with no
                     tuning, planning or building; a bucket whose
                     environment differs takes the live compile path.
    capture:         the engine's ``compile(capture=)``: None captures
                     each bucket on the card; False serves eagerly.
    async_dispatch:  double-buffered dispatch (the default); False is the
                     blocking baseline.
    placement:       optional placement object (``.kind`` "pipeline" or
                     "data"; see the module docstring).

    Resilience (the reference's names and defaults):

    retry:           :class:`RetryPolicy` for failed batches (None: one
                     attempt, no retry); backoff stamps
                     ``Request.not_before`` on the server's clock.
    max_queue:       submits beyond this queue depth resolve ``rejected``
                     (None: unbounded).
    validate:        check each payload at ``submit`` (numeric, finite,
                     the engine's input shape when no ``preprocess``
                     rewrites it); False lets it through, and a bad row
                     then fails alone at staging.
    degrade:         keep a ladder a bucket and demote it after
                     ``demote_after`` consecutive failures (False:
                     ``health`` is None, a failing bucket retries on its
                     mode and resolves ``error``, and ``metrics()["mode"]``
                     is the engine's).
    demote_after:    consecutive failures that demote a bucket one rung
                     down its ladder (to the engine device's floor).
    probe_after_s:   a quarantined mode is re-probed after this long
                     (doubling per re-offense).
    watchdog_s:      bound each readback (None: wait for it, no thread).
    sleep:           how ``drain`` waits out retry backoff when every
                     queued request is ineligible (tests pass a fake that
                     advances their fake clock).
    journal:         a :class:`~repro_torch.serving.recovery.
                     RequestJournal`, or None.
    """

    def __init__(self, engine, *, max_batch: int = 8,
                 max_wait_s: float = 0.0,
                 buckets: tuple[int, ...] = (1, 2, 4, 8),
                 preprocess: Callable[[np.ndarray], Any] | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 retry: RetryPolicy | None = RetryPolicy(),
                 max_queue: int | None = None,
                 validate: bool = True,
                 degrade: bool = True,
                 demote_after: int = 2,
                 probe_after_s: float = 30.0,
                 watchdog_s: float | None = None,
                 sleep: Callable[[float], None] | None = None,
                 tenant: str | None = None, artifact: str | None = None,
                 journal=None, capture: bool | None = None,
                 async_dispatch: bool = True, placement=None):
        self.engine = engine
        self.preprocess = preprocess
        self.async_dispatch = async_dispatch
        self.placement = placement
        self.pipeline_devices: tuple | None = None
        self.data_devices: tuple | None = None
        if placement is not None:
            kind = getattr(placement, "kind", None)
            if kind == "pipeline":
                self.pipeline_devices = tuple(placement.devices)
            elif kind == "data":
                self.data_devices = tuple(placement.devices)
            else:
                raise ValueError(f"placement {placement!r} has no valid "
                                 f".kind ('data' | 'pipeline')")
        self.data_parallel = (len(self.data_devices)
                              if self.data_devices is not None else 1)
        if self.data_parallel > 1:
            dp = self.data_parallel
            buckets = tuple(sorted({-(-b // dp) * dp for b in buckets}))
            max_batch = max(max_batch, buckets[0])
        self.scheduler = BatchScheduler(max_batch=max_batch,
                                        max_wait_s=max_wait_s,
                                        buckets=tuple(buckets))
        self.clock = clock
        self.tenant = tenant
        self.capture = capture
        self.journal = journal
        self.retry = retry
        self.max_queue = max_queue
        self.validate = validate
        self.watchdog_s = watchdog_s
        self._sleep = sleep if sleep is not None \
            else (lambda s: time.sleep(min(s, 0.05)))
        # One ladder a bucket: a pathological bucket demotes only itself;
        # ``health.mode`` is the worst bucket's rung.  On the card the
        # ladder ends at the last hand-written rung.  ``degrade=False``:
        # no ladder, a failing bucket retries on its mode and errors.
        self.health = BucketHealth(
            engine.matmul_mode, demote_after=demote_after,
            probe_after_s=probe_after_s,
            floor=ladder_floor(engine.device)) if degrade else None
        self._pending: _InFlight | None = None
        # Requests resolved ``error`` since the last step() returned:
        # terminal completions, handed back beside the served ones.
        self._errored: list[Request] = []
        self._metrics = ServingMetrics(clock)
        self.flight = FlightRecorder(
            tags={"tenant": tenant} if tenant is not None else None)
        # Padded bucket rows dispatched since construction (what the card
        # paid for): the cost a multiplexer charges each tenant's vtime.
        self.dispatched_rows = 0
        self.artifact_report: dict | None = None
        if artifact is not None and placement is not None:
            # An artifact holds single-device buckets: a placed server
            # would build its own and leave them unused.
            raise ValueError("artifact= serves single-device buckets; it "
                             "does not combine with placement=")
        if artifact is not None:
            self.artifact_report = engine.load_artifact(
                artifact, buckets=tuple(self.scheduler.buckets),
                capture=capture)

    # ---- executor cache ---------------------------------------------------
    def _executable(self, bucket: int, mode: str | None = None):
        """The engine's executor for ``bucket`` under this server's
        placement."""
        kw = {}
        if self.pipeline_devices is not None:
            kw["pipeline"] = self.pipeline_devices
        elif self.data_devices is not None:
            kw["data_parallel"] = self.data_devices
        return self.engine.compile(bucket, mode=mode, capture=self.capture,
                                   **kw)

    def compile_buckets(self) -> dict[int, float]:
        """Build (and run once) every bucket's executor; returns seconds
        per bucket.  After this, serving builds nothing (``build_count``
        stays flat) unless a bucket demotes to a rung not built yet."""
        timings: dict[int, float] = {}
        for b in self.scheduler.buckets:
            with _trace.span("compile.bucket", "compile", bucket=b):
                t0 = time.perf_counter()
                exe = self._executable(b)
                x = torch.zeros(self.engine._plan_shape(b),
                                dtype=torch.uint8, device=self.engine.device)
                exe(x)
                if self.engine.device.type == "cuda":
                    torch.cuda.synchronize(self.engine.device)
                timings[b] = time.perf_counter() - t0
        return timings

    # ---- admission --------------------------------------------------------
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

    def _journal_resolve(self, r: Request) -> None:
        if self.journal is not None and r.jid is not None:
            self.journal.resolve(r.jid, r.outcome, error=r.error)

    def _reject(self, payload: Any, reason: str, now: float,
                deadline_s: float | None, jid: int | None) -> Request:
        r = Request(payload, deadline_s=deadline_s)
        r.jid = jid
        r.arrival_s = now
        r.resolve("rejected", error=reason)
        self._journal_resolve(r)
        self._metrics.record_rejected()
        self.flight.record(id=r.id, outcome="rejected", error=reason,
                           arrival_s=now, done_s=now, latency_s=0.0)
        _trace.instant("serve.reject", "serve", req=r.id, reason=reason)
        return r

    # ---- request lifecycle ------------------------------------------------
    def submit(self, payload: Any, deadline_s: float | None = None,
               now: float | None = None, jid: int | None = None) -> Request:
        """``jid`` is the journal-replay path: the submit record is on
        disk already, so the server attaches its identity instead of
        journaling a second submit."""
        # Arrival is stamped from the server's clock so latency samples
        # stay in one clock domain when a fake clock is injected.
        now = self.clock() if now is None else now
        if self.validate:
            err = self._payload_error(payload)
            if err is not None:
                return self._reject(payload, err, now, deadline_s, jid)
        if self.max_queue is not None \
                and len(self.scheduler) >= self.max_queue:
            return self._reject(
                payload, f"queue full ({len(self.scheduler)} >= "
                         f"max_queue={self.max_queue})", now, deadline_s,
                jid)
        if self.journal is not None and jid is None:
            # Write-ahead: the submit record is on disk before the request
            # enters the scheduler, so a crash in between replays it.
            jid = self.journal.submit("bnn", payload)
        r = self.scheduler.submit(payload, deadline_s=deadline_s, now=now)
        r.jid = jid
        _trace.instant("serve.submit", "serve", req=r.id)
        return r

    def poll(self, request: Request) -> bool:
        return request.done

    # ---- failure handling -------------------------------------------------
    def _retry_or_fail(self, r: Request, exc: Exception, now: float,
                       requeue: list[Request]) -> None:
        """One failed attempt of one request: back off and requeue, or
        resolve ``error`` when its attempts are spent."""
        r.attempts += 1
        max_attempts = self.retry.max_attempts if self.retry else 1
        if r.attempts < max_attempts:
            r.not_before = now + self.retry.backoff_s(r.attempts)
            self._metrics.record_retry()
            _trace.instant("serve.retry", "serve", req=r.id,
                           attempt=r.attempts)
            requeue.append(r)
            return
        r.resolve("error", error=f"{type(exc).__name__}: {exc}")
        self._journal_resolve(r)
        self._metrics.record_error()
        self._errored.append(r)
        self.flight.record(
            id=r.id, outcome="error", error=r.error, attempts=r.attempts,
            arrival_s=r.arrival_s, deadline_s=r.deadline_s, done_s=now,
            latency_s=now - r.arrival_s)
        _trace.instant("serve.error", "serve", req=r.id)

    def _note_demotion(self, now: float, bucket: int) -> None:
        d = self.health.ladder(bucket).demotions[-1]
        self._metrics.record_degraded()
        _obs_metrics.get_registry().event("demotion", server="bnn", **d)
        self.flight.record(kind="demotion", outcome="demoted",
                           from_mode=d["from_mode"], to_mode=d["to_mode"],
                           bucket=bucket, done_s=now)
        _trace.instant("serve.demote", "serve", bucket=bucket,
                       from_mode=d["from_mode"], to_mode=d["to_mode"])

    def _on_batch_failure(self, batch: list[Request], exc: Exception,
                          now: float, mode: str | None, probing: bool,
                          bucket: int) -> None:
        """A whole dispatched or scattered batch failed: update the
        bucket's ladder (perhaps demoting it; other buckets are
        untouched), then retry or fail each request."""
        if self.health is not None:
            if probing:
                self.health.probe_failed(bucket, mode, now)
            elif self.health.record_failure(bucket, now) is not None:
                self._note_demotion(now, bucket)
        requeue: list[Request] = []
        for r in batch:
            self._retry_or_fail(r, exc, now, requeue)
        if requeue:
            self.scheduler.requeue(requeue)

    # ---- dispatch / scatter ----------------------------------------------
    def _stage_rows(self, batch: list[Request], payloads: list[Any]
                    ) -> tuple[list[torch.Tensor], list[Request], list[int],
                               list[tuple[Request, Exception]]]:
        """Host staging with per-row isolation: a payload whose preprocess
        raises, or whose row does not fit the bucket's input (shape and
        uint8 dtype — a copy into a captured input would cast it
        silently), is zero-filled (zeros are inert, as bucket padding is)
        so the rest of the batch still dispatches; its request comes back
        as a failure."""
        want = tuple(self.engine._plan_shape(1)[1:])
        rows: list[torch.Tensor | None] = []
        kept: list[Request] = []
        row_idx: list[int] = []
        failures: list[tuple[Request, Exception]] = []
        for i, p in enumerate(payloads):
            r = batch[i] if i < len(batch) else None
            try:
                if r is not None and _inject._PLAN is not None:
                    _inject.maybe_fault("server.preprocess", req=r.id)
                row = (self.preprocess(np.asarray(p))
                       if self.preprocess is not None else np.asarray(p))
                row = torch.as_tensor(row)
                if tuple(row.shape) != want or row.dtype != torch.uint8:
                    raise ValueError(
                        f"staged row {tuple(row.shape)} {row.dtype} does "
                        f"not fit the bucket's input {want} torch.uint8")
                rows.append(row)
                if r is not None:
                    kept.append(r)
                    row_idx.append(i)
            except Exception as e:      # noqa: BLE001 — isolate the row
                rows.append(None)
                if r is not None:
                    failures.append((r, e))
        where = next((t.device for t in rows if t is not None), None)
        zero = torch.zeros(want, dtype=torch.uint8, device=where)
        return ([zero if t is None else t.to(where) for t in rows], kept,
                row_idx, failures)

    def _launch(self, exe, rows: list[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """Queue one batch through ``exe``: (the host tensor its output
        lands in, the event that marks it there; None on the CPU)."""
        device = self.engine.device
        if isinstance(exe, _executor.Captured):
            # Written straight into the bucket's static input (a host
            # batch through pinned memory).
            dst = exe.static_input
            if rows[0].device == dst.device:
                torch.stack(rows, out=dst)
            elif rows[0].is_cuda:
                dst.copy_(torch.stack(rows))
            else:
                dst.copy_(torch.stack(rows).pin_memory(), non_blocking=True)
            out = exe.replay()                        # queued: returns now
        else:
            x = torch.stack(rows)
            if device.type != "cuda":
                return exe(x.to(device)), None
            if not x.is_cuda:                         # a host batch
                x = x.pin_memory().to(device, non_blocking=True)
            out = exe(x)
        # Queued on the replay's stream (the output's device: a pipeline's
        # last stage), so before the next replay can overwrite the graph's
        # output; one buffer a dispatch, so a batch the watchdog abandoned
        # never shares it.
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with torch.cuda.device(out.device):
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return host, event

    def _dispatch(self, batch: list[Request], payloads: list[Any],
                  mode: str) -> tuple[_InFlight | None,
                                      list[tuple[Request, Exception]]]:
        t0 = self.clock()
        bucket = len(payloads)
        with _trace.span("serve.stage", "serve", bucket=bucket,
                         n_real=len(batch)):
            rows, kept, row_idx, failures = self._stage_rows(batch,
                                                             payloads)
        if not kept:
            return None, failures
        if _inject._PLAN is not None:
            _inject.maybe_fault("server.dispatch", bucket=bucket,
                                mode=mode or self.engine.matmul_mode,
                                tenant=self.tenant)
        with _trace.span("serve.dispatch", "serve", bucket=bucket,
                         mode=mode):
            exe = self._executable(bucket, mode)
            host, event = self._launch(exe, rows)
        self.dispatched_rows += bucket
        self._metrics.mark_dispatch(bucket=bucket)
        t1 = self.clock()
        return (_InFlight(kept, row_idx, host, event, bucket, t1, t1 - t0,
                          mode), failures)

    def _try_dispatch(self, batch: list[Request], payloads: list[Any],
                      now: float) -> _InFlight | None:
        """Dispatch with the whole failure protocol: this bucket's mode
        (its ladder, or a due re-probe of a quarantined mode), batch-level
        retry on failure, per-row failures resolved alone."""
        bucket = len(payloads)
        mode, probing = None, False
        if self.health is not None:
            # The ladder exists from a bucket's first dispatch, so the
            # per-bucket surface covers every bucket that served.
            self.health.ladder(bucket)
            probe = self.health.probe_due(bucket, now)
            mode, probing = ((probe, True) if probe is not None
                             else (self.health.mode_for(bucket), False))
        try:
            flight, failures = self._dispatch(batch, payloads, mode)
        except Exception as e:          # noqa: BLE001 — never kill the loop
            self._on_batch_failure(batch, e, now, mode, probing, bucket)
            return None
        requeue: list[Request] = []
        for r, exc in failures:
            self._retry_or_fail(r, exc, now, requeue)
        if requeue:
            self.scheduler.requeue(requeue)
        # The health verdict waits for the readback: a queued dispatch is
        # no proof the executor works.
        if flight is not None:
            flight.probing = probing
        return flight

    def _readback(self, flight: _InFlight) -> np.ndarray:
        """The one blocking point, bounded by the watchdog when one is
        set: a stalled batch raises :class:`WatchdogTimeout` instead of
        hanging the serve loop (the reader thread is a daemon and is
        abandoned with its buffer)."""
        def blocking() -> np.ndarray:
            if _inject._PLAN is not None:
                _inject.maybe_fault("server.device", bucket=flight.bucket,
                                    tenant=self.tenant)
            if flight.event is not None:
                flight.event.synchronize()
            return flight.host.numpy()

        if self.watchdog_s is None:
            return blocking()
        box: dict[str, Any] = {}

        def work():
            try:
                box["out"] = blocking()
            except Exception as e:      # noqa: BLE001 — re-raised below
                box["err"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(self.watchdog_s)
        if th.is_alive():
            raise WatchdogTimeout(
                f"device readback exceeded watchdog_s={self.watchdog_s}")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _scatter(self, flight: _InFlight) -> list[Request]:
        with _trace.span("serve.device", "serve", bucket=flight.bucket):
            host = self._readback(flight)         # the one blocking point
        now = self.clock()
        with _trace.span("serve.scatter", "serve",
                         n_real=len(flight.batch)):
            for r, i in zip(flight.batch, flight.row_idx):
                r.resolve("served", host[i])
                self._journal_resolve(r)
        self._metrics.record([now - r.arrival_s for r in flight.batch])
        for r in flight.batch:
            self.flight.record(
                id=r.id, outcome="served", bucket=flight.bucket,
                arrival_s=r.arrival_s, deadline_s=r.deadline_s,
                dispatched_s=flight.t_dispatch, done_s=now,
                queue_s=flight.t_dispatch - r.arrival_s,
                stage_s=flight.stage_s, latency_s=now - r.arrival_s,
                attempts=r.attempts, mode=flight.mode)
        return flight.batch

    def _try_scatter(self, flight: _InFlight, now: float) -> list[Request]:
        try:
            done = self._scatter(flight)
        except Exception as e:          # noqa: BLE001 — never kill the loop
            self._on_batch_failure(flight.batch, e, now, flight.mode,
                                   flight.probing, flight.bucket)
            return []
        if flight.probing:
            # The quarantined faster mode survived its probe end to end:
            # this bucket's ladder goes back up.
            self.health.promote(flight.bucket, flight.mode)
            _trace.instant("serve.promote", "serve", mode=flight.mode,
                           bucket=flight.bucket)
            self.flight.record(kind="promotion", outcome="promoted",
                               to_mode=flight.mode, bucket=flight.bucket,
                               done_s=now)
        elif self.health is not None:
            self.health.record_success(flight.bucket)
        return done

    def _record_shed(self, shed: list[Request], now: float) -> None:
        self._metrics.record_dropped(len(shed))
        for r in shed:
            self._journal_resolve(r)
            self.flight.record(id=r.id, outcome="shed",
                               arrival_s=r.arrival_s,
                               deadline_s=r.deadline_s, done_s=now,
                               latency_s=now - r.arrival_s)
            _trace.instant("serve.shed", "serve", req=r.id)

    def step(self, now: float | None = None, force: bool = False,
             dispatch: bool = True) -> list[Request]:
        """One serving tick: dispatch the next batch (policy permitting),
        then scatter the previously in-flight one.  Returns the requests
        completed this tick, the ones that resolved ``error`` included.
        Failures never escape: a faulted batch requeues (retry policy) or
        resolves ``error``, and the loop goes on.  ``dispatch=False`` runs
        the housekeeping half only — shed expired requests, scatter the
        in-flight batch — as a multiplexer does on the lanes it did not
        pick."""
        now = self.clock() if now is None else now
        # Shed before assembly, so the flight recorder sees every deadline
        # outcome (padded_batch sheds too, at the same ``now``: nothing is
        # left for it to shed).
        shed = self.scheduler.shed_expired(now)
        if shed:
            self._record_shed(shed, now)
        flight = None
        if dispatch:
            with _trace.span("serve.assemble", "serve"):
                got = self.scheduler.padded_batch(now, force=force)
            if got is not None:
                flight = self._try_dispatch(*got, now)
        done: list[Request] = []
        if not self.async_dispatch:
            # The blocking baseline: this batch completes in its own step.
            if flight is not None:
                done = self._try_scatter(flight, now)
        else:
            pending, self._pending = self._pending, flight
            if pending is not None:
                done = self._try_scatter(pending, now)
        if self._errored:
            done, self._errored = done + self._errored, []
        return done

    def _abort_wedged(self, now: float) -> list[Request]:
        """Drain's last resort: resolve everything still outstanding
        ``error``, so no request is left hanging."""
        stuck: list[Request] = []
        if self._pending is not None:
            stuck += self._pending.batch
            self._pending = None
        while len(self.scheduler):         # requests in backoff too
            stuck.append(self.scheduler._queue.popleft())
        for r in stuck:
            if r.done:
                continue
            r.resolve("error", error="drain wedged: step budget exhausted")
            self._journal_resolve(r)
            self._metrics.record_error()
            self.flight.record(id=r.id, outcome="error", error=r.error,
                               arrival_s=r.arrival_s, done_s=now,
                               latency_s=now - r.arrival_s)
        return [r for r in stuck if r.outcome == "error"]

    def drain(self, now: float | None = None,
              max_steps: int | None = None) -> list[Request]:
        """Serve until the queue is empty and nothing is in flight (the
        batch-wait policy is skipped: drain is a flush).  Returns the
        requests completed during the drain.

        Bounded: at most ``max_steps`` ticks (default generous for the
        queue and the retry budget), after which whatever is outstanding
        resolves ``error``.  When every queued request is in backoff it
        waits through the injectable ``sleep`` (a fixed explicit ``now``
        cannot advance, so backoff under it falls to the step bound)."""
        if max_steps is None:
            budget = self.retry.max_attempts if self.retry else 1
            max_steps = 4 * (len(self.scheduler) + 2) * budget + 16
        done: list[Request] = []
        steps = 0
        while len(self.scheduler) or self._pending is not None:
            if steps >= max_steps:
                done += self._abort_wedged(
                    self.clock() if now is None else now)
                break
            steps += 1
            t = self.clock() if now is None else now
            done += self.step(t, force=True)
            if self._pending is None and len(self.scheduler):
                wait = self.scheduler.backoff_wait(t)
                if wait is not None and wait > 0:
                    self._sleep(wait)
        return done

    # ---- observability ----------------------------------------------------
    @property
    def metrics_registry(self):
        """This server's series: ``serve.latency_s``, ``serve.bucket_size``,
        ``serve.served``, ``serve.dropped``, ``serve.retries``,
        ``serve.errors``, ``serve.rejected``, ``serve.degraded``."""
        return self._metrics.registry

    @property
    def queue_depth(self) -> int:
        inflight = len(self._pending.batch) if self._pending else 0
        return len(self.scheduler) + inflight

    def metrics(self) -> dict:
        """p50/p95 request latency (submit→scatter, ms), served/dropped
        counts, the resilience counters (retries, errors, rejected,
        degraded), live queue depth, the dispatch kind, the shard count,
        the serving mode (the worst bucket's rung), each bucket's ladder,
        the placement and the throughput over the busy window (first
        dispatch → last scatter)."""
        extra = {"tenant": self.tenant} if self.tenant is not None else {}
        if self.health is not None and self.health.ladders:
            extra["bucket_health"] = {
                b: lad.snapshot(self.clock())
                for b, lad in sorted(self.health.ladders.items())}
        if self.pipeline_devices is not None:
            extra["placement"] = {"kind": "pipeline",
                                  "devices": [str(d) for d in
                                              self.pipeline_devices]}
        elif self.data_devices is not None:
            extra["placement"] = {"kind": "data",
                                  "shards": self.data_parallel}
        return self._metrics.snapshot(
            dropped=self.scheduler.dropped, queue_depth=self.queue_depth,
            async_dispatch=self.async_dispatch,
            data_parallel=self.data_parallel,
            mode=(self.health.mode if self.health is not None
                  else self.engine.matmul_mode),
            buckets=list(self.scheduler.buckets), **extra)
