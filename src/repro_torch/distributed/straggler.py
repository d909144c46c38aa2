"""Straggler detection (host side, framework layer).

Counterpart of ``repro.distributed.straggler``.  Slow hosts or cards
(thermal throttling, noisy neighbours) gate everything that waits on
them.  :class:`StragglerMonitor` keeps an EWMA and variance of step wall
times and flags a step longer than ``mean + k * std`` (k = 3) that is
also ``min_ratio`` slower than the mean.  Mitigation is a hook:

* ``on_warn(step, dt, mean)`` — each flagged step;
* ``on_persistent(step)`` — after ``persistent_after`` consecutive
  flagged steps.

Replica-group serving (:mod:`repro_torch.distributed.replicas`) wires the
persistent hook to its router, which then treats the lane like a demoted
one until a step is not flagged.  The monitor depends on nothing and is
tested by feeding it step times.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


@dataclasses.dataclass
class StragglerMonitor:
    threshold_sigma: float = 3.0
    # A step must also be min_ratio slower than the mean: near-constant
    # step times make sigma tiny, and jitter would flag without it.
    min_ratio: float = 0.3
    min_samples: int = 10
    persistent_after: int = 5
    ewma_alpha: float = 0.05
    on_warn: Callable[[int, float, float], None] | None = None
    on_persistent: Callable[[int], None] | None = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _consecutive: int = 0
    _t0: float | None = None
    flagged_steps: list = dataclasses.field(default_factory=list)

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        if self._t0 is None:
            raise RuntimeError("stop() before start()")
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        """Record one step's duration; True if it is flagged."""
        flagged = False
        if self._n >= self.min_samples:
            std = math.sqrt(max(self._var, 1e-12))
            if (dt > self._mean + self.threshold_sigma * std
                    and dt > self._mean * (1 + self.min_ratio)):
                flagged = True
                self.flagged_steps.append((step, dt))
                self._consecutive += 1
                if self.on_warn:
                    self.on_warn(step, dt, self._mean)
                if (self._consecutive >= self.persistent_after
                        and self.on_persistent):
                    self.on_persistent(step)
                    self._consecutive = 0
            else:
                self._consecutive = 0
        # Only unflagged steps update the baseline, so one slow stretch
        # does not become the new normal.
        if not flagged:
            a = self.ewma_alpha if self._n else 1.0
            delta = dt - self._mean
            self._mean += a * delta
            self._var = (1 - a) * (self._var + a * delta * delta)
        self._n += 1
        return flagged

    @property
    def mean_step_time(self) -> float:
        return self._mean
