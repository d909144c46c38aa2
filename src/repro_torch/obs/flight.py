"""Flight recorder: a bounded ring of recent request records
(DESIGN.md §10.3).

Counterpart of ``repro.obs.flight``.  The postmortem surface of a
long-running server: when a latency spike or a burst of deadline sheds
shows in the metrics, ``dump()`` gives the last N requests with arrival
time, bucket, outcome and per-stage timings — without the unbounded
growth of a full trace.  Plain host-side bookkeeping (a
``deque(maxlen=...)`` of dicts), always on, O(1) a request.
"""

from __future__ import annotations

from collections import deque


class FlightRecorder:
    """Keeps the most recent ``capacity`` request records."""

    def __init__(self, capacity: int = 256, tags: dict | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        # Fields stamped onto every record — how a multi-tenant server
        # marks each lane's records with its tenant name.
        self.tags = dict(tags) if tags else {}
        self._records: deque[dict] = deque(maxlen=capacity)

    def record(self, **fields) -> dict:
        """Append one request record (free-form fields; the servers write
        id/arrival_s/bucket/outcome/latency_s and stage timings)."""
        if self.tags:
            fields = {**self.tags, **fields}
        self._records.append(fields)
        return fields

    def __len__(self) -> int:
        return len(self._records)

    def dump(self) -> list[dict]:
        """Oldest-to-newest copies of the retained records."""
        return [dict(r) for r in self._records]

    def last(self, n: int = 1) -> list[dict]:
        return [dict(r) for r in list(self._records)[-n:]]

    def clear(self) -> None:
        self._records.clear()
