"""Span tracing with Chrome trace-event export (DESIGN.md §10.1).

Counterpart of ``repro.obs.trace``.  One process-wide :class:`Tracer`
behind a module-level slot.  Tracing is **disabled by default**: while the
slot is ``None``, :func:`span` returns a shared no-op context manager
without allocating anything — a disabled site costs one global read and
one ``is None`` test.  Spans are host-side only: they never wait for the
device and never touch a tensor, so enabling tracing cannot change what
a kernel computes::

    from repro_torch.obs import trace

    tracer = trace.install()            # tracing on
    with trace.span("serve.dispatch", "serve", bucket=4):
        ...
    tracer.export("trace.json")         # chrome://tracing / Perfetto
    trace.uninstall()                   # tracing off again

The export is the Chrome trace-event format (``ph: "X"`` complete events
with ``ts``/``dur`` in microseconds, ``ph: "i"`` instants), loadable in
``chrome://tracing`` and Perfetto; :func:`validate_trace` is its schema
check.  A span's duration is host wall time: on the card, work queued in
a span may still run after it closes (``serve.device`` is the span that
waits for a batch's results).

Span taxonomy: ``serve.*`` for the request path, ``executor.call`` for
one forward, ``compile.*`` for bucket compilation, ``autotune.*`` for
sweeps.

``Tracer(annotate=True)`` also enters a ``torch.profiler.record_function``
a span, so host spans line up with device kernels when a
``torch.profiler`` session is active; :meth:`Tracer.start_profiler` /
:meth:`Tracer.stop_profiler` manage such a session (best-effort: absent
profiler support is not an error).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any


class _NullSpan:
    """The disabled-tracing span: a shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

# The process tracer.  ``None`` means disabled — the fast path the serving
# loop and the executor read directly (one attribute load a site).
_TRACER: "Tracer | None" = None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> "Tracer | None":
    return _TRACER


def install(tracer: "Tracer | None" = None) -> "Tracer":
    """Install (and return) the process tracer; tracing is on after this."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def uninstall() -> "Tracer | None":
    """Disable tracing; returns the tracer that was installed (if any)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, kind: str = "host", **attrs) -> Any:
    """A span scope on the installed tracer — or the shared no-op when
    tracing is disabled."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, kind, **attrs)


def instant(name: str, kind: str = "host", **attrs) -> None:
    """A zero-duration marker event (no-op when disabled)."""
    t = _TRACER
    if t is not None:
        t.instant(name, kind, **attrs)


class Span:
    """One open scope; appends a complete ('X') event on exit."""

    __slots__ = ("_tracer", "name", "kind", "attrs", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, kind: str,
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self._t0 = 0.0
        self._ann = None

    def set(self, **attrs) -> "Span":
        """Attach attrs discovered mid-span (output shapes, counts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if self._tracer.annotate:
            try:
                import torch

                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:           # noqa: BLE001 — best-effort
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._emit_complete(self.name, self.kind, self._t0, t1,
                                    self.attrs)
        return False


class Tracer:
    """Collects span/instant events; exports Chrome trace-event JSON.

    ``max_events`` bounds memory on long runs: past it, new events are
    counted in ``dropped_events`` instead of stored (the flight recorder
    is the postmortem surface of a long-running server; traces are for
    bounded captures).
    """

    def __init__(self, max_events: int = 200_000, annotate: bool = False):
        self.max_events = max_events
        self.annotate = annotate
        self.events: list[dict] = []
        self.dropped_events = 0
        self._epoch = time.perf_counter()
        self._profiler = None

    # ---- recording --------------------------------------------------------
    def span(self, name: str, kind: str = "host", **attrs) -> Span:
        return Span(self, name, kind, attrs)

    def instant(self, name: str, kind: str = "host", **attrs) -> None:
        ts = (time.perf_counter() - self._epoch) * 1e6
        self._append({"ph": "i", "name": name, "cat": kind,
                      "ts": ts, "s": "t", "pid": 0,
                      "tid": threading.get_ident() & 0xFFFF,
                      "args": attrs})

    def _emit_complete(self, name: str, kind: str, t0: float, t1: float,
                       attrs: dict) -> None:
        self._append({"ph": "X", "name": name, "cat": kind,
                      "ts": (t0 - self._epoch) * 1e6,
                      "dur": max((t1 - t0) * 1e6, 0.0),
                      "pid": 0,
                      "tid": threading.get_ident() & 0xFFFF,
                      "args": attrs})

    def _append(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped_events += 1
            return
        self.events.append(ev)

    # ---- queries ----------------------------------------------------------
    def spans(self, prefix: str = "") -> list[dict]:
        """Complete ('X') events, optionally filtered by name prefix."""
        return [e for e in self.events
                if e["ph"] == "X" and e["name"].startswith(prefix)]

    # ---- torch.profiler session (optional) --------------------------------
    def start_profiler(self, logdir: str) -> bool:
        """Start a ``torch.profiler`` session (CPU and, with a card, CUDA
        activity) alongside the host spans; its trace lands in ``logdir``
        when :meth:`stop_profiler` ends it.  Best-effort: returns whether
        it started."""
        try:
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts,
                           on_trace_ready=tensorboard_trace_handler(logdir))
            prof.start()
        except Exception:               # noqa: BLE001 — best-effort
            return False
        self._profiler = prof
        return True

    def stop_profiler(self) -> None:
        prof, self._profiler = self._profiler, None
        if prof is not None:
            try:
                prof.stop()
            except Exception:           # noqa: BLE001 — best-effort
                pass

    # ---- export -----------------------------------------------------------
    def to_chrome(self, meta: dict | None = None) -> dict:
        """The Chrome trace-event document (sorted by ts), stamped with
        provenance metadata."""
        if meta is None:
            from repro_torch.obs.provenance import provenance_meta

            meta = provenance_meta()
        events = sorted(self.events, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": dict(meta, dropped_events=self.dropped_events)}

    def export(self, path: str, meta: dict | None = None) -> dict:
        doc = self.to_chrome(meta)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc


def validate_trace(doc: dict | list) -> list[dict]:
    """Minimal schema check for an exported trace: every complete event
    carries name/ts/dur, and complete events on one (pid, tid) track
    properly nest — any two either are disjoint or one contains the
    other.  Returns the complete events; raises ``ValueError`` on a
    violation."""
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    complete = []
    for e in events:
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"event without a name: {e!r}")
        if e.get("ph") == "X":
            if not isinstance(e.get("ts"), (int, float)):
                raise ValueError(f"span without ts: {e['name']}")
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                raise ValueError(f"span without dur: {e['name']}")
            complete.append(e)
    by_track: dict[tuple, list[dict]] = {}
    for e in complete:
        by_track.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for track in by_track.values():
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[tuple[float, float]] = []
        for e in track:
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack and t1 > stack[-1][1] + 1e-6:
                raise ValueError(
                    f"span {e['name']!r} [{t0}, {t1}] overlaps its "
                    f"enclosing span {stack[-1]} without nesting")
            stack.append((t0, t1))
    return complete
