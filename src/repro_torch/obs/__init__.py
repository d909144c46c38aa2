"""Observability (counterpart of ``repro.obs``, DESIGN.md §10).

    trace       span tracing with Chrome/Perfetto trace-event export;
                disabled by default behind a no-op fast path
    metrics     counters/gauges/histograms/events registry, the one
                percentile/summary implementation, and the ServingMetrics
                view both servers share
    flight      bounded ring of recent request records (postmortems)
    inject      the fault-injection slot: typed faults, seeded plans and
                the one hook every instrumented site calls; disabled by
                default behind the same one-read fast path
    provenance  the ``meta`` block a stamped report carries

The contract: with tracing disabled (the default) a hot-path site costs
one global read; enabling it adds host-side spans only, so served results
stay bit-exact (``tests/test_torch_obs.py``).
"""

from repro_torch.obs import metrics, trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (MetricsRegistry, ServingMetrics,
                                     get_registry, percentile, summarize,
                                     use_registry)
from repro_torch.obs.provenance import provenance_meta, stamp, write_bench
from repro_torch.obs.trace import (Tracer, get_tracer, install, span,
                                   uninstall, validate_trace)

__all__ = [
    "FlightRecorder", "MetricsRegistry", "ServingMetrics", "Tracer",
    "get_registry", "get_tracer", "install", "metrics", "percentile",
    "provenance_meta", "span", "stamp", "summarize", "trace", "uninstall",
    "use_registry", "validate_trace", "write_bench",
]
