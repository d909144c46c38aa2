"""Serving metrics: the latency math the servers report.

Counterpart of the parts of ``repro.obs.metrics`` the serving slice uses:
:func:`percentile` (copied as is) and :class:`ServingMetrics`, which keeps
the reference's ``metrics()`` keys for what the port reports — served,
dropped, errors, rejected, queue depth, p50/p95 latency and throughput over
the busy window.  The registry, tracing and the retry and degradation
series are not ported.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Sequence


def percentile(sorted_vals: Sequence[float], p: float) -> float | None:
    """Nearest-rank percentile of an ascending sequence (None when
    empty): the smallest value with at least ``p`` of the sample at or
    below it, i.e. index ``ceil(p*n) - 1``."""
    n = len(sorted_vals)
    if not n:
        return None
    return sorted_vals[max(0, min(n - 1, math.ceil(p * n) - 1))]


class ServingMetrics:
    """Latency/throughput bookkeeping on the owner's (injectable) clock."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.latencies: list[float] = []
        self.served = 0
        self.errors = 0
        self.rejected = 0
        self._t_first: float | None = None
        self._t_last: float | None = None

    def mark_dispatch(self) -> None:
        """Device work entered flight: the busy window opens at the first."""
        if self._t_first is None:
            self._t_first = self._clock()

    def record(self, latencies: list[float]) -> None:
        """A batch of requests completed with these submit→done times."""
        self.latencies.extend(latencies)
        self.served += len(latencies)
        self._t_last = self._clock()

    def record_error(self, n: int = 1) -> None:
        self.errors += n

    def record_rejected(self, n: int = 1) -> None:
        self.rejected += n

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
            "errors": self.errors,
            "rejected": self.rejected,
            "queue_depth": queue_depth,
            "p50_ms": None if not lat else percentile(lat, 0.50) * 1e3,
            "p95_ms": None if not lat else percentile(lat, 0.95) * 1e3,
            "throughput": (self.served / busy if busy else None),
            **extra,
        }
