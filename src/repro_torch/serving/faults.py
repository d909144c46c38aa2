"""Retry policy and backend degradation (DESIGN.md §11).

Counterpart of ``repro.serving.faults``: the resilience layer's three
pieces, one vocabulary for "what can go wrong and what the server does
about it".

* **Fault injection** — :mod:`repro_torch.obs.inject`, kept below the
  runtime and serving layers so either can host a site; its names
  (``FaultSpec``, ``FaultPlan``, ``install``, ``maybe_fault``, the fault
  types, ...) are re-exported here under the reference's module.

* **Retry policy** — :class:`RetryPolicy`: capped exponential backoff
  with seeded jitter.  The server owns the clock; the policy only does
  the math, so backoff runs the same under a fake clock.

* **Degradation ladder** — :data:`DEGRADE_LADDER` orders the port's
  serving backends fast-but-fragile to slow-but-safe, the reference's
  ladder through ``kernels.ops.JAX_MODE``: ``cuda_chain`` (K5 regions),
  ``cuda_direct_pool``, ``cuda_direct`` (K3), ``cuda_popcount`` (K2),
  then the plain PyTorch rungs ``torch_pm1`` and ``torch``.
  :class:`BackendHealth` demotes a serving mode after ``demote_after``
  consecutive failures, quarantines it and re-probes it after a
  (failure-doubling) interval; :class:`BucketHealth` keeps one such
  ladder a batch bucket.  A demotion is a counted, recorded event of the
  server (``serve.degraded``, a ``demotion`` event, a flight record, a
  ``serve.demote`` instant) that moves one bucket's mode.

The ladder's floor depends on where the engine runs (:func:`ladder_floor`).
On the CPU it is the whole ladder, down to ``torch``, as the reference's
goes down to ``xla``.  On the card it ends at ``cuda_popcount``, the last
hand-written rung: a card engine never serves through the plain PyTorch
versions (the kernel wrappers' rule, ``kernels/ops.py``, that nothing
falls back holds for the server too), and a bucket that keeps failing
there resolves its requests ``error`` once their retries are spent.

What the ladder can survive on the card: injected faults, a
``torch.cuda.OutOfMemoryError`` (the allocator refuses, the context is
intact), and errors raised while a rung's executor is built or captured
(a Python-side refusal, an nvcc failure, a capture that raises).  What it
cannot: a sticky CUDA error — an illegal address, a misaligned access, a
device-side assert, a kernel that never ends — poisons the process's
CUDA context, every later call on it fails, and no rung of any ladder
recovers; such a process must be restarted (the request journal of
:mod:`repro_torch.serving.recovery` is what replays its unresolved
requests).

Everything here is host-side bookkeeping: nothing is captured into a
CUDA graph, and with no plan installed every site costs one global read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs.inject import (FAULT_KINDS, LATENCY_SPIKE, SITES,
                                    CompileFault, DeviceFault, DeviceOOM,
                                    FaultError, FaultPlan, FaultSpec,
                                    PreprocessFault, WatchdogTimeout,
                                    get_plan, inject, install, maybe_fault,
                                    uninstall)

__all__ = [
    "DEGRADE_LADDER", "FAULT_KINDS", "LATENCY_SPIKE", "SITES",
    "BackendHealth", "BucketHealth", "CUDA_FLOOR", "CompileFault", "DeviceFault",
    "DeviceOOM", "FaultError", "FaultPlan", "FaultSpec", "PreprocessFault",
    "RetryPolicy", "WatchdogTimeout", "demote_mode", "get_plan", "inject",
    "install", "ladder_floor", "ladder_rank", "maybe_fault", "uninstall",
]

# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetryPolicy:
    """Capped exponential backoff with seeded jitter.

    ``max_attempts`` counts *all* tries (1 = no retry).  The delay before
    retry ``k`` (the first retry is ``k=1``) is::

        min(base * 2**(k-1), cap) * (1 + jitter * U[-1, 1))

    The policy only does the math: the server applies the delay on its
    own (injectable) clock by stamping ``Request.not_before``."""

    max_attempts: int = 3
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 1.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self._rng = np.random.default_rng(self.seed)

    def backoff_s(self, attempt: int) -> float:
        exp = min(self.backoff_base_s * 2.0 ** (max(attempt, 1) - 1),
                  self.backoff_cap_s)
        if not self.jitter:
            return exp
        return exp * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))


# ---------------------------------------------------------------------------
# Backend degradation ladder
# ---------------------------------------------------------------------------

#: The port's serving modes, fast-but-fragile to slow-but-safe: the
#: executor's ``_FALLBACK`` chain extended down to the plain PyTorch
#: rungs.  Every rung computes the same binarized network bit for bit
#: (each is held against the flat oracle); the pm1 and xor rungs may
#: differ only in the float head's last-ulp accumulation order, so a
#: demotion changes latency, never the packed computation.
DEGRADE_LADDER = ("cuda_chain", "cuda_direct_pool", "cuda_direct",
                  "cuda_popcount", "torch_pm1", "torch")

#: The last hand-written rung: the floor of a ladder on the card.
CUDA_FLOOR = "cuda_popcount"


def ladder_floor(device: torch.device | str) -> str:
    """The ladder's last rung for an engine on ``device``: ``torch`` on
    the CPU, ``cuda_popcount`` on the card."""
    return CUDA_FLOOR if torch.device(device).type == "cuda" \
        else DEGRADE_LADDER[-1]


def ladder_rank(mode: str) -> int:
    """Position in the ladder; modes outside it (``"auto"``,
    ``cuda_pm1``) rank above everything: their one demotion is straight
    to the floor, and a successful re-probe restores them."""
    try:
        return DEGRADE_LADDER.index(mode)
    except ValueError:
        return -1


def demote_mode(mode: str, floor: str = DEGRADE_LADDER[-1]) -> str | None:
    """The next-safer serving mode above or at ``floor``; None at the
    floor and for a mode below it (a card engine serving ``torch``)."""
    rank = ladder_rank(mode)
    if rank < 0:
        return floor
    if rank >= ladder_rank(floor):
        return None
    return DEGRADE_LADDER[rank + 1]


class BackendHealth:
    """The live serving mode through failures, demotions, quarantine and
    re-probe.

    * ``record_failure`` — one failure at the current mode; after
      ``demote_after`` consecutive ones the mode is quarantined (until
      now + its probe interval, doubling on each re-offense) and the
      ladder's next mode becomes current.  Returns the new mode on a
      demotion, else None.
    * ``record_success`` — resets the consecutive-failure count.
    * ``probe_due`` — the best quarantined mode whose quarantine has
      expired (to try ahead of the current one), if any.
    * ``promote`` / ``probe_failed`` — resolve a probe: adopt the probed
      mode, or quarantine it again for a doubled interval.

    ``floor`` is the last rung a demotion reaches (:func:`ladder_floor`
    of the engine's device); modes outside the ladder demote straight to
    it."""

    def __init__(self, mode: str, *, demote_after: int = 2,
                 probe_after_s: float = 30.0, probe_backoff: float = 2.0,
                 floor: str = DEGRADE_LADDER[-1]):
        if demote_after < 1:
            raise ValueError("demote_after must be >= 1")
        if floor not in DEGRADE_LADDER:
            raise ValueError(f"floor {floor!r} is not a rung of "
                             f"{DEGRADE_LADDER}")
        self.mode = mode
        self.floor = floor
        self.demote_after = demote_after
        self.probe_after_s = probe_after_s
        self.probe_backoff = probe_backoff
        self._consecutive = 0
        # mode -> (quarantined until, current interval)
        self._quarantine: dict[str, tuple[float, float]] = {}
        self.demotions: list[dict] = []

    # ---- failure accounting ----------------------------------------------
    def record_failure(self, now: float) -> str | None:
        self._consecutive += 1
        if self._consecutive < self.demote_after:
            return None
        return self._demote(now)

    def record_success(self) -> None:
        self._consecutive = 0

    def _demote(self, now: float) -> str | None:
        self._consecutive = 0
        nxt = demote_mode(self.mode, self.floor)
        if nxt is None:                       # already at the floor
            return None
        self._quarantine_mode(self.mode, now)
        old, self.mode = self.mode, nxt
        self.demotions.append(dict(t=now, from_mode=old, to_mode=nxt))
        return nxt

    def _quarantine_mode(self, mode: str, now: float) -> None:
        prev = self._quarantine.get(mode)
        interval = (prev[1] * self.probe_backoff if prev
                    else self.probe_after_s)
        self._quarantine[mode] = (now + interval, interval)

    # ---- re-probe ---------------------------------------------------------
    def probe_due(self, now: float) -> str | None:
        best: str | None = None
        for mode, (until, _) in self._quarantine.items():
            if now < until or ladder_rank(mode) >= ladder_rank(self.mode):
                continue
            if best is None or ladder_rank(mode) < ladder_rank(best):
                best = mode
        return best

    def promote(self, mode: str) -> None:
        self._quarantine.pop(mode, None)
        self.mode = mode
        self._consecutive = 0

    def probe_failed(self, mode: str, now: float) -> None:
        self._quarantine_mode(mode, now)

    def snapshot(self, now: float) -> dict:
        return {
            "mode": self.mode,
            "demotions": len(self.demotions),
            "quarantined": {m: max(0.0, until - now)
                            for m, (until, _) in self._quarantine.items()},
        }


class BucketHealth:
    """Per-bucket degradation ladders: one :class:`BackendHealth` a
    batch bucket, created at its first dispatch, so one pathological
    bucket shape demotes only its own ladder while the other buckets keep
    their fast backend.

    The aggregate views — ``mode``, the most-demoted bucket's mode, and
    ``demotions``, every bucket's log in time order with each entry's
    ``bucket`` — keep ``server.health.mode`` / ``.demotions`` meaningful
    for a caller that wants one number."""

    def __init__(self, mode: str, *, demote_after: int = 2,
                 probe_after_s: float = 30.0, probe_backoff: float = 2.0,
                 floor: str = DEGRADE_LADDER[-1]):
        self.base_mode = mode
        self._kw = dict(demote_after=demote_after,
                        probe_after_s=probe_after_s,
                        probe_backoff=probe_backoff, floor=floor)
        self.ladders: dict[int, BackendHealth] = {}

    def ladder(self, bucket: int) -> BackendHealth:
        """The (lazily created) ladder for one batch bucket."""
        lad = self.ladders.get(bucket)
        if lad is None:
            lad = self.ladders[bucket] = BackendHealth(self.base_mode,
                                                       **self._kw)
        return lad

    # ---- the BackendHealth protocol, bucket-scoped ------------------------
    def mode_for(self, bucket: int) -> str:
        lad = self.ladders.get(bucket)
        return lad.mode if lad is not None else self.base_mode

    def record_failure(self, bucket: int, now: float) -> str | None:
        lad = self.ladder(bucket)
        demoted = lad.record_failure(now)
        if demoted is not None:
            lad.demotions[-1]["bucket"] = bucket
        return demoted

    def record_success(self, bucket: int) -> None:
        lad = self.ladders.get(bucket)
        if lad is not None:
            lad.record_success()

    def probe_due(self, bucket: int, now: float) -> str | None:
        lad = self.ladders.get(bucket)
        return lad.probe_due(now) if lad is not None else None

    def promote(self, bucket: int, mode: str) -> None:
        self.ladder(bucket).promote(mode)

    def probe_failed(self, bucket: int, mode: str, now: float) -> None:
        self.ladder(bucket).probe_failed(mode, now)

    # ---- aggregate views --------------------------------------------------
    @property
    def mode(self) -> str:
        """The most-demoted bucket's mode (the server's worst rung);
        ``base_mode`` when nothing demoted."""
        worst = self.base_mode
        for lad in self.ladders.values():
            if ladder_rank(lad.mode) > ladder_rank(worst):
                worst = lad.mode
        return worst

    @property
    def demotions(self) -> list[dict]:
        """Every bucket's demotion log in time order, each entry with its
        ``bucket``."""
        rows = [d for lad in self.ladders.values() for d in lad.demotions]
        return sorted(rows, key=lambda d: d["t"])

    def snapshot(self, now: float) -> dict:
        return {
            "mode": self.mode,
            "demotions": len(self.demotions),
            "buckets": {b: lad.snapshot(now)
                        for b, lad in sorted(self.ladders.items())},
        }
