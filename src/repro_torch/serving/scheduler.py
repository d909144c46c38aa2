"""Request batching for serving.

Counterpart of ``repro.serving.scheduler`` (plain Python + numpy).  Policy:
assemble the largest batch available up to ``max_batch``, but never hold a
request longer than ``max_wait_s``.  Batches are padded to the nearest
bucket size so each batch hits an executor the engine already built;
padding is zero-filled (shaped like the last real payload) and the padded
tail of the results is discarded.

A request may carry a ``deadline_s`` (seconds of queue residency it will
tolerate); expired requests are shed — resolved ``shed`` with
``result=None`` and counted in ``dropped``.  :func:`shed_expired_requests`
is the one shed policy, shared with the LM server's admission queue.

A request in retry backoff (``not_before`` in the future) keeps its place
in the queue but is passed over by batch assembly until its delay has
passed; ``requeue`` puts a failed batch's requests back at the head and
``backoff_wait`` says how long a queue starved only by backoff must wait.

Every time-dependent method takes an injectable ``now=`` (monotonic
seconds) so policy is testable with a fake clock.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any

import numpy as np

#: The terminal request outcomes: every submitted request ends
#: ``done=True`` with exactly one of these.
OUTCOMES = ("served", "shed", "error", "rejected")


@dataclasses.dataclass
class Request:
    payload: Any
    arrival_s: float = dataclasses.field(default_factory=time.monotonic)
    deadline_s: float | None = None   # max queue residency; None = patient
    id: int = dataclasses.field(
        default_factory=itertools.count().__next__)
    result: Any = None
    done: bool = False
    outcome: str | None = None        # one of OUTCOMES once done
    error: str | None = None          # why, for rejected / error
    attempts: int = 0                 # dispatch tries so far
    not_before: float | None = None   # retry backoff: ineligible until
    jid: int | None = None            # request-journal id, if journaled

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None
                and (now - self.arrival_s) >= self.deadline_s)

    def eligible(self, now: float) -> bool:
        """A request in retry backoff sits in the queue but skips
        assembly."""
        return self.not_before is None or now >= self.not_before

    def resolve(self, outcome: str, result: Any = None,
                error: str | None = None) -> "Request":
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}")
        self.result, self.done, self.outcome = result, True, outcome
        self.error = error
        return self


def shed_expired_requests(queue: "deque[Request]", now: float
                          ) -> tuple["deque[Request]", list[Request]]:
    """Partition a request queue into (kept, shed by deadline); shed
    requests resolve ``shed`` with ``result=None``."""
    kept: deque[Request] = deque()
    shed: list[Request] = []
    for r in queue:
        if r.expired(now):
            shed.append(r.resolve("shed"))
        else:
            kept.append(r)
    return kept, shed


def _zero_like(payload: Any) -> Any:
    """A zero payload with the shape/dtype of a real one (batch padding)."""
    return np.zeros_like(np.asarray(payload))


def buckets_for(max_batch: int,
                ladder: tuple[int, ...] = (1, 2, 4, 8, 16)) -> tuple[int, ...]:
    """The power-of-two ladder below ``max_batch`` plus ``max_batch``."""
    return tuple(sorted({b for b in ladder if b < max_batch} | {max_batch}))


@dataclasses.dataclass
class BatchScheduler:
    max_batch: int = 8
    max_wait_s: float = 0.005
    buckets: tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        self._queue: deque[Request] = deque()
        self.dropped = 0          # deadline-shed requests (overload stat)
        if tuple(sorted(self.buckets)) != tuple(self.buckets):
            raise ValueError(f"buckets {self.buckets} must be ascending")
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")

    def submit(self, payload: Any, deadline_s: float | None = None,
               now: float | None = None) -> Request:
        r = Request(payload, deadline_s=deadline_s)
        if now is not None:
            r.arrival_s = now
        self._queue.append(r)
        return r

    def __len__(self) -> int:
        return len(self._queue)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def shed_expired(self, now: float | None = None) -> list[Request]:
        """Pop every expired request (done, result=None); count them."""
        if not self._queue:
            return []
        now = time.monotonic() if now is None else now
        self._queue, shed = shed_expired_requests(self._queue, now)
        self.dropped += len(shed)
        return shed

    def ready(self, now: float | None = None) -> bool:
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        now = time.monotonic() if now is None else now
        return (now - self._queue[0].arrival_s) >= self.max_wait_s

    def next_batch(self, now: float | None = None,
                   force: bool = False) -> list[Request] | None:
        """Shed expired requests, then pop up to max_batch *eligible*
        requests if the policy says go (``force=True`` skips the wait
        policy).  Requests in retry backoff keep their place and are
        passed over until their delay has passed."""
        now = time.monotonic() if now is None else now
        self.shed_expired(now)
        if not (self._queue if force else self.ready(now)):
            return None
        take: list[Request] = []
        keep: deque[Request] = deque()
        for r in self._queue:
            if len(take) < self.max_batch and r.eligible(now):
                take.append(r)
            else:
                keep.append(r)
        if not take:
            return None
        self._queue = keep
        return take

    def requeue(self, requests: list[Request]) -> None:
        """Put a failed batch's requests back at the head for retry, in
        their order (they were at the head when popped)."""
        for r in reversed(requests):
            self._queue.appendleft(r)

    def backoff_wait(self, now: float) -> float | None:
        """Seconds until the soonest queued request leaves retry
        backoff; None when the queue is empty or something is eligible
        already (only meaningful when assembly is starved by backoff
        alone)."""
        if not self._queue or any(r.eligible(now) for r in self._queue):
            return None
        return min(r.not_before for r in self._queue) - now

    def padded_batch(self, now: float | None = None, force: bool = False
                     ) -> tuple[list[Request], list[Any]] | None:
        """Pop a batch and zero-pad its payloads to the bucket size: every
        executed payload list is exactly a bucket size, and rows past
        ``len(batch)`` are padding."""
        batch = self.next_batch(now, force=force)
        if batch is None:
            return None
        bucket = self.bucket_for(len(batch))
        payloads = [r.payload for r in batch]
        pad = bucket - len(batch)
        if pad:
            payloads = payloads + [_zero_like(payloads[-1])] * pad
        return batch, payloads
