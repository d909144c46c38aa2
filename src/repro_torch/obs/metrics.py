"""Metrics registry: counters, gauges, histograms, structured events
(DESIGN.md §10.2).

Counterpart of ``repro.obs.metrics``, with the same names and semantics:
the one nearest-rank :func:`percentile` / :func:`summarize` the servers,
the tests and the summaries share; :class:`Counter`, :class:`Gauge` and
:class:`Histogram`; a :class:`MetricsRegistry` of named metrics plus a
bounded ring of structured events (the autotuner's hit/miss audit trail);
the process registry behind :func:`get_registry` / :func:`set_registry` /
:func:`use_registry`; and :class:`ServingMetrics`, the view both servers
report through.

A registry is plain host-side bookkeeping — integer adds and list
appends, nothing on the device — always on, nanoseconds an update.  The
process registry holds the runtime-wide series (``autotune.*``,
``runtime.arena_peak_bytes``, ``runtime.chain_hbm_bytes_avoided``); each
server keeps a private one for its ``serve.*`` series.

Metric naming: dot-separated ``subsystem.metric`` with the unit in the
suffix (``_s`` seconds, ``_ms`` milliseconds, ``_bytes`` bytes).
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import deque
from typing import Callable, Iterable, Sequence


# ---- canonical percentile / summary math ----------------------------------

def percentile(sorted_vals: Sequence[float], p: float) -> float | None:
    """Nearest-rank percentile of an ascending sequence (None when
    empty): the smallest value with at least ``p`` of the sample at or
    below it, i.e. index ``ceil(p*n) - 1``."""
    n = len(sorted_vals)
    if not n:
        return None
    return sorted_vals[max(0, min(n - 1, math.ceil(p * n) - 1))]


def summarize(samples: Iterable[float]) -> dict:
    """count/min/max/mean/p50/p95 of a sample (the one summary shape)."""
    vals = sorted(samples)
    if not vals:
        return {"count": 0, "min": None, "max": None, "mean": None,
                "p50": None, "p95": None}
    return {"count": len(vals), "min": vals[0], "max": vals[-1],
            "mean": sum(vals) / len(vals),
            "p50": percentile(vals, 0.50), "p95": percentile(vals, 0.95)}


# ---- primitives ------------------------------------------------------------

class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (e.g. a plan's ``peak_bytes``)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Sample accumulator, summarized by :func:`summarize`."""

    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = name
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(v)

    def observe_many(self, vals: Iterable[float]) -> None:
        self.samples.extend(vals)

    @property
    def count(self) -> int:
        return len(self.samples)

    def summary(self) -> dict:
        return summarize(self.samples)


class MetricsRegistry:
    """Named counters/gauges/histograms plus a bounded structured-event
    ring (``event()``)."""

    def __init__(self, max_events: int = 4096):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._events: deque[dict] = deque(maxlen=max_events)

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # ---- structured events ------------------------------------------------
    def event(self, name: str, **fields) -> dict:
        ev = dict(event=name, **fields)
        self._events.append(ev)
        return ev

    def events(self, name: str | None = None) -> list[dict]:
        return [e for e in self._events
                if name is None or e["event"] == name]

    # ---- reporting --------------------------------------------------------
    def snapshot(self) -> dict:
        """name -> value (counters/gauges) or summary dict (histograms)."""
        return {name: m.summary() if isinstance(m, Histogram) else m.value
                for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        self._metrics.clear()
        self._events.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process registry (what the runtime instrumentation writes to)."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the process registry; returns the old one."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, registry
    return prev


@contextlib.contextmanager
def use_registry(registry: MetricsRegistry | None = None):
    """Swap in a registry (default: a fresh one) for a scope — how tests
    isolate their counts from the process registry."""
    reg = registry if registry is not None else MetricsRegistry()
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)


# ---- serving metrics (shared by both servers) ------------------------------

class ServingMetrics:
    """Latency/throughput bookkeeping shared by both servers: the latency
    and bucket-size histograms, the served/dropped/retry/error/rejected/
    degraded counters and the busy window, on the owner's (injectable)
    clock.  Each instance keeps a private registry, ``.registry``
    (``serve.latency_s``, ``serve.bucket_size``, ...), so two servers in
    one process never sum each other's counts.  ``retries`` counts the
    attempts a retry policy requeued and ``degraded`` the demotions down
    a bucket's backend ladder (:mod:`repro_torch.serving.faults`)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.registry = MetricsRegistry()
        self._lat = self.registry.histogram("serve.latency_s")
        self._served = self.registry.counter("serve.served")
        self._dropped = self.registry.counter("serve.dropped")
        self._buckets = self.registry.histogram("serve.bucket_size")
        self._retries = self.registry.counter("serve.retries")
        self._errors = self.registry.counter("serve.errors")
        self._rejected = self.registry.counter("serve.rejected")
        self._degraded = self.registry.counter("serve.degraded")
        self._t_first: float | None = None
        self._t_last: float | None = None

    @property
    def latencies(self) -> list[float]:
        return self._lat.samples

    @property
    def served(self) -> int:
        return self._served.value

    def mark_dispatch(self, bucket: int | None = None) -> None:
        """Device work entered flight: the busy window opens at the first.
        ``bucket`` (when known) feeds the bucket-size histogram."""
        if bucket is not None:
            self._buckets.observe(bucket)
        if self._t_first is None:
            self._t_first = self._clock()

    def record(self, latencies: list[float]) -> None:
        """A batch of requests completed with these submit→done times."""
        self._lat.observe_many(latencies)
        self._served.inc(len(latencies))
        self._t_last = self._clock()

    def record_dropped(self, n: int = 1) -> None:
        self._dropped.inc(n)

    def record_retry(self, n: int = 1) -> None:
        self._retries.inc(n)

    def record_error(self, n: int = 1) -> None:
        self._errors.inc(n)

    def record_rejected(self, n: int = 1) -> None:
        self._rejected.inc(n)

    def record_degraded(self, n: int = 1) -> None:
        self._degraded.inc(n)

    def snapshot(self, *, dropped: int, queue_depth: int, **extra) -> dict:
        """The ``metrics()`` keys; ``dropped`` is the owner's shed count
        (the scheduler's, or ``LMServer.dropped``)."""
        lat = sorted(self.latencies)
        busy = (self._t_last - self._t_first
                if self._t_first is not None and self._t_last is not None
                else None)
        return {
            "served": self.served,
            "dropped": dropped,
            "retries": self._retries.value,
            "errors": self._errors.value,
            "rejected": self._rejected.value,
            "degraded": self._degraded.value,
            "queue_depth": queue_depth,
            "p50_ms": None if not lat else percentile(lat, 0.50) * 1e3,
            "p95_ms": None if not lat else percentile(lat, 0.95) * 1e3,
            "throughput": (self.served / busy if busy else None),
            **extra,
        }
