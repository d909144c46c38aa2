"""Port parity: the observability layer against ``repro.obs``.

* ``percentile`` / ``summarize`` on seeded numpy samples, and the
  registry (counters, gauges, histograms, the type-conflict error, the
  bounded event ring, ``use_registry`` isolation) driven through the same
  operations on both sides: equal results.
* ``FlightRecorder``: ring order and capacity, the same dumps as the
  reference's.
* The tracer: the shared null span when disabled, nesting, ``set``, the
  event cap; the port's Chrome export passes both packages'
  ``validate_trace``.
* ``provenance_meta`` names torch, CUDA and the device, never jax.
* Serving: a traced ``InferenceServer`` run on the tiny workload gives the
  untraced rows bit for bit; with tracing off no tracer is touched; the
  flight recorder sees served and shed requests; ``LMServer`` records its
  requests and emits its instants.

The reference's wall-clock overhead bound is not ported: a timing bound
on a shared CPU is a flaky test.
"""

import json

import numpy as np
import pytest
import torch

from repro.obs import flight as j_flight
from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro_torch import obs
from repro_torch import workloads
from repro_torch.models import transformer
from repro_torch.obs import flight, metrics, provenance, trace
from repro_torch.serving.lm_server import LMServer

SEED = 11


@pytest.fixture
def tracer():
    """A fresh port tracer for one test; always uninstalled after."""
    t = trace.install()
    yield t
    trace.uninstall()


@pytest.fixture(scope="module")
def tiny():
    return workloads.get("alexnet_imagenet", variant="tiny", device="cpu",
                         matmul_mode="torch", seed=SEED)


def _images(wl, n: int, seed: int = SEED) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    h, w = wl.input_hw
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


# --------------------------------------------------------------------------
# Percentiles and the registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 1001])
def test_percentile_and_summarize_match_reference(n):
    vals = sorted(np.random.default_rng(n).exponential(3.0, n).tolist())
    for p in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        assert metrics.percentile(vals, p) == j_metrics.percentile(vals, p)
    assert metrics.summarize(vals) == j_metrics.summarize(vals)


def _drive(mod):
    """The same registry operations on one package's metrics module."""
    reg = mod.MetricsRegistry(max_events=5)
    reg.counter("a.count").inc()
    reg.counter("a.count").inc(4)
    reg.gauge("a.bytes").set(1234)
    reg.gauge("a.bytes").set(99)
    h = reg.histogram("a.latency_s")
    h.observe(0.5)
    h.observe_many([0.1, 0.9, 0.3])
    for i in range(8):
        reg.event("tick" if i % 2 else "tock", i=i)
    try:
        reg.gauge("a.count")
    except TypeError as e:
        conflict = str(e)
    else:
        conflict = None
    out = dict(snapshot=reg.snapshot(), events=reg.events(),
               ticks=reg.events("tick"), count=h.count, conflict=conflict)
    reg.reset()
    out["after_reset"] = (reg.snapshot(), reg.events())
    return out


def test_registry_matches_reference():
    got, want = _drive(metrics), _drive(j_metrics)
    assert got == want
    assert got["snapshot"]["a.count"] == 5
    assert got["snapshot"]["a.bytes"] == 99
    assert got["snapshot"]["a.latency_s"]["count"] == 4
    assert len(got["events"]) == 5                   # bounded ring
    assert [e["i"] for e in got["ticks"]] == [3, 5, 7]
    assert "already registered as Counter" in got["conflict"]
    assert got["after_reset"] == ({}, [])


def test_use_registry_isolates():
    outer = metrics.get_registry()
    with metrics.use_registry() as reg:
        assert metrics.get_registry() is reg and reg is not outer
        metrics.get_registry().counter("x").inc()
        with metrics.use_registry() as inner:
            assert inner.snapshot() == {}
        assert metrics.get_registry() is reg
    assert metrics.get_registry() is outer
    assert "x" not in outer.snapshot()
    mine = metrics.MetricsRegistry()
    prev = metrics.set_registry(mine)
    try:
        assert metrics.get_registry() is mine
    finally:
        metrics.set_registry(prev)


def test_serving_metrics_keys_match_reference():
    t = {"now": 0.0}
    got = metrics.ServingMetrics(lambda: t["now"])
    want = j_metrics.ServingMetrics(lambda: t["now"])
    for m in (got, want):
        m.mark_dispatch(bucket=4)
        t["now"] += 1.0
        m.record([0.2, 0.4, 0.6])
        m.record_error()
        m.record_rejected(2)
        m.record_dropped()
    assert got.snapshot(dropped=1, queue_depth=3) \
        == want.snapshot(dropped=1, queue_depth=3)
    assert got.registry.snapshot() == want.registry.snapshot()


# --------------------------------------------------------------------------
# Flight recorder
# --------------------------------------------------------------------------

def test_flight_recorder_ring_matches_reference():
    got = flight.FlightRecorder(3)
    want = j_flight.FlightRecorder(3)
    for i in range(5):
        got.record(id=i, outcome="served")
        want.record(id=i, outcome="served")
    assert got.dump() == want.dump()
    assert [r["id"] for r in got.dump()] == [2, 3, 4]
    assert len(got) == 3 and got.last(2) == want.last(2)
    got.clear()
    assert len(got) == 0 and got.dump() == []
    with pytest.raises(ValueError):
        flight.FlightRecorder(0)


# --------------------------------------------------------------------------
# Tracer
# --------------------------------------------------------------------------

def test_disabled_returns_shared_null_span():
    assert trace.get_tracer() is None and not trace.enabled()
    s = trace.span("anything", "x", a=1)
    assert s is trace.NULL_SPAN
    with s as inner:
        assert inner.set(b=2) is trace.NULL_SPAN
    trace.instant("nothing")                      # a no-op, no error


def test_spans_nest_set_and_export(tracer, tmp_path):
    with trace.span("outer", "test", depth=0) as sp:
        with trace.span("inner", "test", depth=1):
            trace.instant("mark", "test", k=3)
        sp.set(extra="yes")
    outer, inner = tracer.spans("outer")[0], tracer.spans("inner")[0]
    assert outer["args"] == {"depth": 0, "extra": "yes"}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    doc = tracer.export(str(tmp_path / "trace.json"), meta={"run": "t"})
    loaded = json.loads((tmp_path / "trace.json").read_text())
    assert loaded == doc
    assert [e["name"] for e in loaded["traceEvents"]] \
        == ["outer", "inner", "mark"]
    assert loaded["metadata"] == {"run": "t", "dropped_events": 0}
    # The export passes both packages' schema checks.
    assert len(trace.validate_trace(loaded)) == 2
    assert len(j_trace.validate_trace(loaded)) == 2


def test_event_cap_counts_drops():
    t = trace.Tracer(max_events=3)
    for i in range(5):
        t.instant("e", i=i)
    assert len(t.events) == 3 and t.dropped_events == 2
    assert t.to_chrome(meta={})["metadata"]["dropped_events"] == 2


def test_validate_rejects_partial_overlap():
    bad = [{"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0,
            "pid": 0, "tid": 0},
           {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0,
            "pid": 0, "tid": 0}]
    for validate in (trace.validate_trace, j_trace.validate_trace):
        with pytest.raises(ValueError):
            validate(bad)
    with pytest.raises(ValueError):
        trace.validate_trace([{"ph": "X", "ts": 0, "dur": 1}])


def test_annotated_spans_and_profiler_session(tmp_path):
    """``annotate=True`` enters a ``record_function`` a span, so the spans
    show in a ``torch.profiler`` session the tracer started; stopping it
    writes the session's trace to the log directory."""
    t = trace.Tracer(annotate=True)
    assert t.start_profiler(str(tmp_path))
    with t.span("outer.annotated", "test"):
        torch.ones(8).sum()
    t.stop_profiler()
    t.stop_profiler()                             # a second stop: no-op
    assert [e["name"] for e in t.spans()] == ["outer.annotated"]
    written = list(tmp_path.iterdir())
    assert len(written) == 1
    assert "outer.annotated" in written[0].read_text()


def test_uninstall_restores_fast_path():
    t = trace.install()
    assert trace.get_tracer() is t
    assert trace.uninstall() is t
    assert trace.span("x") is trace.NULL_SPAN


def test_chrome_export_carries_port_provenance(tracer):
    with trace.span("one"):
        pass
    meta = tracer.to_chrome()["metadata"]
    assert meta["torch"] == torch.__version__
    assert "jax" not in meta and meta["dropped_events"] == 0


# --------------------------------------------------------------------------
# Provenance
# --------------------------------------------------------------------------

def test_provenance_meta_names_torch_not_jax():
    meta = provenance.provenance_meta()
    assert meta["schema"] == "bench-meta-v1"
    assert meta["torch"] == torch.__version__
    assert meta["cuda"] == torch.version.cuda
    assert {"device_kind", "n_devices", "backends", "git_sha",
            "timestamp"} <= set(meta)
    assert not any("jax" in k for k in meta)
    assert "cuda_direct_pool" in meta["backends"]
    if not torch.cuda.is_available():
        assert meta["n_devices"] == 0 and meta["device_kind"] is None


def test_write_bench_stamps(tmp_path):
    out = tmp_path / "report.json"
    stamped = obs.write_bench(out, {"value": 3})
    loaded = json.loads(out.read_text())
    assert loaded == stamped and loaded["value"] == 3
    assert loaded["meta"]["torch"] == torch.__version__
    assert out.read_text().endswith("\n")


# --------------------------------------------------------------------------
# Serving: tracing off is free, on is harmless
# --------------------------------------------------------------------------

def _serve(wl, imgs):
    server = wl.server(max_batch=4, buckets=(1, 2, 4))
    server.compile_buckets()
    reqs = [server.submit(im) for im in imgs]
    server.drain()
    assert all(r.outcome == "served" for r in reqs)
    return server, np.stack([r.result for r in reqs])


def test_disabled_serving_never_touches_tracer(tiny, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("tracer touched with tracing off")
    monkeypatch.setattr(trace.Tracer, "span", boom)
    monkeypatch.setattr(trace.Tracer, "instant", boom)
    assert trace.get_tracer() is None
    server, _ = _serve(tiny, _images(tiny, 6))
    assert server.metrics()["served"] == 6


def test_traced_serving_bit_exact(tiny, tracer):
    imgs = _images(tiny, 5, seed=SEED + 1)
    trace.uninstall()
    _, untraced = _serve(tiny, imgs)
    trace.install(tracer)
    server, traced = _serve(tiny, imgs)
    np.testing.assert_array_equal(traced, untraced)
    names = {e["name"] for e in tracer.events}
    assert {"compile.bucket", "serve.submit", "serve.assemble",
            "serve.stage", "serve.dispatch", "serve.device",
            "serve.scatter", "executor.call"} <= names
    doc = tracer.to_chrome(meta={})
    trace.validate_trace(doc)
    j_trace.validate_trace(doc)


def test_flight_recorder_sees_served_and_shed(tiny, tracer):
    t = {"now": 0.0}
    server = tiny.server(max_batch=2, buckets=(1, 2),
                         clock=lambda: t["now"])
    img = _images(tiny, 1)[0]
    server.submit(img, deadline_s=1.0)               # will expire
    ok = server.submit(img)
    bad = server.submit(np.zeros((3, 3), np.uint8) * np.nan)
    t["now"] = 2.0
    server.drain()
    assert ok.outcome == "served" and bad.outcome == "rejected"
    records = server.flight.dump()
    assert sorted(r["outcome"] for r in records) \
        == ["rejected", "served", "shed"]
    shed = next(r for r in records if r["outcome"] == "shed")
    assert shed["deadline_s"] == 1.0 and shed["done_s"] == 2.0
    served = next(r for r in records if r["outcome"] == "served")
    assert served["latency_s"] == pytest.approx(2.0)
    assert served["queue_s"] <= served["latency_s"] and served["bucket"] == 1
    names = [e["name"] for e in tracer.events if e["ph"] == "i"]
    assert {"serve.shed", "serve.reject", "serve.submit"} <= set(names)
    assert server.metrics()["dropped"] == 1
    assert server._metrics.registry.snapshot()["serve.dropped"] == 1


def test_failed_batch_records_errors(tiny, tracer):
    def flaky(p):
        raise ValueError("corrupt")
    server = tiny.server(preprocess=flaky, max_batch=2, buckets=(1, 2))
    reqs = [server.submit(np.zeros((20, 20, 3), np.uint8))
            for _ in range(2)]
    server.drain()
    assert [r.outcome for r in reqs] == ["error", "error"]
    assert [r["outcome"] for r in server.flight.dump()] == ["error"] * 2
    assert sum(e["name"] == "serve.error" for e in tracer.events) == 2


def test_lm_server_flight_and_instants(tracer):
    cfg = transformer.LMConfig(name="obs-demo", n_layers=1, d_model=64,
                               n_heads=2, n_kv_heads=1, d_head=32, d_ff=128,
                               vocab=128, tie_embeddings=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    server = LMServer(cfg, params, n_slots=2, max_seq=32,
                      clock=lambda: 5.0, device="cpu")
    reqs = [server.submit([1, 2, 3], max_new=2, now=0.0),
            server.submit([4, 5], max_new=2, now=0.0)]
    late = server.submit([6], max_new=1, deadline_s=1.0, now=0.0)
    bad = server.submit([])
    server.drain()
    assert [r.outcome for r in reqs] == ["served", "served"]
    assert late.outcome == "shed" and bad.outcome == "rejected"
    outcomes = sorted(r["outcome"] for r in server.flight.dump())
    assert outcomes == ["rejected", "served", "served", "shed"]
    served = [r for r in server.flight.dump() if r["outcome"] == "served"]
    assert all(r["n_tokens"] == 2 and r["latency_s"] == 5.0
               for r in served)
    names = [e["name"] for e in tracer.events]
    assert names.count("serve.submit") == 3 and "serve.reject" in names
