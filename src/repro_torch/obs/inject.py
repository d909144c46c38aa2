"""The fault-injection slot (DESIGN.md §11): the typed faults, seeded
plans and the one hook every instrumented site calls.

Counterpart of the injection half of ``repro.serving.faults``, kept below
both the runtime and the serving layers so each can host a site without
importing the other: a seeded, deterministic :class:`FaultPlan` of
:class:`FaultSpec` rules, installed process-wide like the tracer (a
module slot and ``install``/``uninstall``; disabled is one global read,
``if inject._PLAN is not None``).  Instrumented *sites* call
:func:`maybe_fault(site, **ctx)`; a matching spec raises the typed fault
(``DeviceOOM``/``DeviceFault``/``CompileFault``/``PreprocessFault``) or,
for ``latency_spike``, stalls through the plan's injectable ``sleep``.
The sites: ``serving/server.py`` (``server.preprocess``,
``server.dispatch``, ``server.device``), ``serving/engine.py``
(``engine.compile``), ``runtime/executor.py`` (``executor.call``: an
eager executor's call and a captured bucket's replay),
``serving/lm_server.py`` (``lm.step``, ``kv.restore``) and
``serving/recovery.py`` (``kv.snapshot``).  A decision is a function of
the seed and each spec's own call count, drawn from numpy's
``default_rng(seed)`` as the reference draws it, so one plan makes the
same decisions in both packages.

What the server does about a fault — retry, the degradation ladder — is
:mod:`repro_torch.serving.faults`, which re-exports these names.
Everything here is host-side: nothing is captured into a CUDA graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.obs import metrics as _obs_metrics

# ---------------------------------------------------------------------------
# Fault taxonomy
# ---------------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of every injected fault; carries the site it fired at.

    ``transient`` tells faults a retry may outlive (device OOM under
    memory pressure, a transient device fault) from deterministic ones (a
    compile error repeats every attempt); the retry policy retries both
    (capped), and the flag is kept for postmortems."""

    kind = "fault"
    transient = False

    def __init__(self, site: str, **ctx):
        self.site, self.ctx = site, dict(ctx)
        extra = f" ({ctx})" if ctx else ""
        super().__init__(f"injected {self.kind} at {site}{extra}")


class DeviceOOM(FaultError):
    """The device allocator refused the batch (transient under load)."""

    kind = "device_oom"
    transient = True


class DeviceFault(FaultError):
    """A transient device or executor failure."""

    kind = "device_fault"
    transient = True


class CompileFault(FaultError):
    """Building an executor failed (deterministic: retries re-raise)."""

    kind = "compile_error"


class PreprocessFault(FaultError):
    """Host preprocessing of one payload raised."""

    kind = "preprocess_error"


class WatchdogTimeout(RuntimeError):
    """The dispatch watchdog expired waiting on a device readback."""


# ``latency_spike`` is the one kind that does not raise: the site stalls
# for ``duration_s`` (through the plan's injectable sleep) and goes on.
LATENCY_SPIKE = "latency_spike"
FAULT_KINDS: dict[str, type[FaultError]] = {
    cls.kind: cls
    for cls in (DeviceOOM, DeviceFault, CompileFault, PreprocessFault)}

#: The instrumented sites.  A plan naming another site is refused at
#: construction (a typo would otherwise never fire).
SITES = ("server.preprocess", "server.dispatch", "server.device",
         "engine.compile", "executor.call", "lm.step",
         "kv.snapshot", "kv.restore")


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultSpec:
    """One injection rule: *where* (site and ctx match), *what* (kind)
    and *when* (a deterministic schedule or a seeded rate).

    Evaluated against this spec's own count of eligible calls:

    * ``after`` — skip the first ``after`` eligible calls;
    * ``every`` — then fire on every ``every``-th call (default 1: every
      call), unless ``rate`` is set;
    * ``rate``  — fire i.i.d. with this probability (the plan's rng);
    * ``times`` — stop after this many fires (None: no limit).

    ``match`` restricts eligibility to calls whose ctx carries the given
    values (``{"mode": "cuda_chain", "bucket": 8}`` faults the fast
    backend of one bucket only, which leaves the demoted path healthy)."""

    site: str
    kind: str
    rate: float | None = None
    times: int | None = None
    after: int = 0
    every: int = 1
    duration_s: float = 0.05          # latency_spike stall
    match: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"want one of {SITES}")
        if self.kind != LATENCY_SPIKE and self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; want one of "
                f"{(*FAULT_KINDS, LATENCY_SPIKE)}")

    def eligible(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())

    def fires(self, n_eligible: int, n_fired: int,
              rng: np.random.Generator) -> bool:
        """Decide for eligible call ``n_eligible`` (0-based)."""
        if n_eligible < self.after:
            return False
        if self.times is not None and n_fired >= self.times:
            return False
        if self.rate is not None:
            return bool(rng.random() < self.rate)
        return (n_eligible - self.after) % self.every == 0


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules and the injection log.

    ``sleep`` is what latency spikes stall through: tests pass a
    fake-clock advancer; the default is the real ``time.sleep``."""

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...],
                 *, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self.specs = list(specs)
        self.sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._eligible = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)
        self.log: list[dict] = []

    def fired(self, site: str | None = None) -> list[dict]:
        return [f for f in self.log if site is None or f["site"] == site]

    def check(self, site: str, **ctx) -> None:
        """Evaluate every spec against one site call; raises the first
        matching fault (latency spikes stall and keep evaluating)."""
        for i, spec in enumerate(self.specs):
            if spec.site != site or not spec.eligible(ctx):
                continue
            n = self._eligible[i]
            self._eligible[i] += 1
            if not spec.fires(n, self._fired[i], self._rng):
                continue
            self._fired[i] += 1
            entry = dict(site=site, kind=spec.kind, call=n, **ctx)
            self.log.append(entry)
            reg = _obs_metrics.get_registry()
            reg.counter("faults.injected").inc()
            reg.event("fault", **entry)
            if spec.kind == LATENCY_SPIKE:
                self.sleep(spec.duration_s)
                continue
            raise FAULT_KINDS[spec.kind](site, **ctx)


# The module slot, shaped as the tracer's: a disabled site costs one
# global read (call sites guard with ``if inject._PLAN is not None``).
_PLAN: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def get_plan() -> FaultPlan | None:
    return _PLAN


def maybe_fault(site: str, **ctx) -> None:
    """The one injection hook every instrumented site calls."""
    plan = _PLAN
    if plan is not None:
        plan.check(site, **ctx)


@contextlib.contextmanager
def inject(specs: FaultPlan | list[FaultSpec] | tuple[FaultSpec, ...],
           **kw):
    """Scoped installation (tests, the chip smoke's fault phase)."""
    plan = specs if isinstance(specs, FaultPlan) else FaultPlan(specs, **kw)
    install(plan)
    try:
        yield plan
    finally:
        uninstall()
