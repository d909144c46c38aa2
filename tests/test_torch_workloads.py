"""Port parity: the serving slice end to end against the JAX package.

* The three tiny workloads under every port mode on the CPU: raw
  output, packed tail (bit for bit) and decoded rows against the JAX
  workload in mode ``xla``, with the same latent params carried across.
* The checked-in goldens ``tests/golden/*.npz``, reproduced by the port
  from params the JAX side builds under ``jax.threefry_partitionable
  (False)`` (the context manager: xdist workers share a process across
  files, so the global config is never touched).
* The served-bucket sweep through the port's ``InferenceServer``.
* At full width (AlexNet, YOLOv2-Tiny, VGG16), the port's lowering equals
  the JAX lowering node for node, attrs and inferred types included.

Tolerances are the harness's (``tests/harness.py``): packed words exact;
float heads and decoded rows within 1e-4, class indices and the detection
validity mask exact.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

import harness
from repro import runtime as j_runtime
from repro.models import paper_nets as j_nets
from repro_torch import workloads as t_workloads
from repro_torch.core import bnn_model as t_bnn
from repro_torch.core import converter as t_conv
from repro_torch.models import paper_nets as t_nets
from repro_torch.runtime import (ALL_MODES, fuse_pool_epilogue, infer_types,
                                 lower_packed)

T_DETECT = t_workloads.DetectConfig(
    score_thresh=harness.CONFORMANCE_DETECT.score_thresh,
    iou_thresh=harness.CONFORMANCE_DETECT.iou_thresh,
    max_det=harness.CONFORMANCE_DETECT.max_det)


@functools.lru_cache(maxsize=None)
def reference(name: str) -> dict:
    """The JAX side, once per workload: params (as numpy) built under the
    golden fixtures' threefry setting, the golden input, and the JAX
    outputs in mode ``xla``."""
    with jax.threefry_partitionable(False):
        wl = harness.conformance_workload(name)
        params = [{k: np.asarray(v) for k, v in p.items()}
                  for p in wl.params]
    x = np.array(harness.seeded_batch(wl))
    raw = np.asarray(wl.engine.raw(x))
    return dict(params=params, x=x, raw=raw,
                decoded=np.asarray(wl.engine._head_jit(raw)),
                packed_tail=harness.packed_tail(wl, x), task=wl.task)


def port_workload(name: str, backend: str = "torch"):
    kw = dict(variant="tiny", device="cpu", matmul_mode=backend,
              params=reference(name)["params"])
    if name == "yolov2_tiny_voc":
        kw["detect"] = T_DETECT
    return t_workloads.get(name, **kw)


def port_packed_tail(wl, x: torch.Tensor) -> np.ndarray:
    cut = len(wl.spec)
    while cut and isinstance(wl.spec[cut - 1],
                             (t_bnn.FloatDense, t_bnn.FloatConv)):
        cut -= 1
    packed = t_conv.convert(wl.params, wl.spec, wl.input_hw)
    out = t_bnn.packed_forward(packed[:cut], wl.spec[:cut], x)
    assert out.dtype == torch.int32
    return out.numpy()


def assert_decoded_close(got: np.ndarray, want: np.ndarray,
                         task: str) -> None:
    assert got.shape == want.shape
    if task == "classify":
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
    else:
        np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
        np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", ALL_MODES)
@pytest.mark.parametrize("name", harness.CONFORMANCE_NAMES)
def test_backend_matches_reference(name, backend):
    ref = reference(name)
    wl = port_workload(name, backend)
    x = torch.from_numpy(ref["x"])
    raw = wl.engine.raw(x)
    np.testing.assert_allclose(raw.numpy(), ref["raw"], rtol=0, atol=1e-4)
    assert_decoded_close(wl.postprocess(raw).numpy(), ref["decoded"],
                         ref["task"])
    np.testing.assert_array_equal(port_packed_tail(wl, x),
                                  ref["packed_tail"])
    # The graph path equals the flat oracle bit for bit.
    wl.engine.cross_check(x)


@pytest.mark.parametrize("name", harness.CONFORMANCE_NAMES)
def test_golden_fixture_reproduced(name):
    golden = harness.load_golden(name)
    ref = reference(name)
    np.testing.assert_array_equal(ref["x"], golden["x"])
    wl = port_workload(name, "cuda_direct_pool")
    x = torch.from_numpy(golden["x"])
    np.testing.assert_array_equal(port_packed_tail(wl, x),
                                  golden["packed_tail"])
    np.testing.assert_allclose(wl.engine.raw(x).numpy(), golden["raw"],
                               rtol=0, atol=1e-4)
    assert_decoded_close(wl.engine(x).numpy(), golden["decoded"], ref["task"])


@pytest.mark.parametrize("name", ("alexnet_imagenet", "yolov2_tiny_voc"))
def test_served_buckets(name):
    """Off-size requests through buckets (1, 2, 4), zero-padded: every row
    equals the port's cross_check on the batch the server ran, and nothing
    is built while serving."""
    wl = port_workload(name, "cuda_direct_pool")
    buckets = (1, 2, 4)
    server = wl.server(max_batch=4, buckets=buckets)
    server.compile_buckets()
    before = wl.engine.build_count
    rng = np.random.default_rng(harness.SEED)
    imgs = [rng.integers(0, 256, (44, 60, 3), dtype=np.uint8)
            for _ in range(6)]
    groups, served = [], 0
    for g in (1, 2, 3):
        batch = imgs[served:served + g]
        reqs = [server.submit(im) for im in batch]
        done = server.drain()
        assert sorted(r.id for r in done) == sorted(r.id for r in reqs)
        served += g
        bucket = server.scheduler.bucket_for(g)
        groups.append((reqs, batch + [np.zeros_like(batch[-1])]
                       * (bucket - g)))
    assert wl.engine.build_count == before, "built while serving"
    m = server.metrics()
    assert m["served"] == 6 and m["dropped"] == 0 and m["queue_depth"] == 0
    assert m["p50_ms"] is not None and m["p95_ms"] >= m["p50_ms"]
    for reqs, padded in groups:
        x = torch.stack([wl.preprocess_hook(p) for p in padded])
        ref = wl.engine.cross_check(x).numpy()
        for r, expect in zip(reqs, ref):
            assert r.outcome == "served"
            np.testing.assert_array_equal(r.result, expect)


def test_malformed_payload_resolves_alone():
    """Paper AlexNet served without a preprocess hook: two good images and
    one a row too tall.  The bad one resolves ``rejected`` at submit, the
    good ones are served and equal ``cross_check``, and ``drain`` returns."""
    wl = t_workloads.get("alexnet_imagenet", device="cpu",
                         matmul_mode="torch")
    server = wl.server(preprocess=None, max_batch=2, buckets=(1, 2))
    h, w = wl.input_hw
    rng = np.random.default_rng(harness.SEED)
    good = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(2)]
    reqs = [server.submit(good[0]),
            server.submit(rng.integers(0, 256, (h + 1, w, 3),
                                       dtype=np.uint8)),
            server.submit(good[1])]
    server.drain()
    assert [r.outcome for r in reqs] == ["served", "rejected", "served"]
    assert "shape" in reqs[1].error
    ref = wl.engine.cross_check(torch.from_numpy(np.stack(good))).numpy()
    np.testing.assert_array_equal(reqs[0].result, ref[0])
    np.testing.assert_array_equal(reqs[2].result, ref[1])
    m = server.metrics()
    assert m["served"] == 2 and m["rejected"] == 1 and m["queue_depth"] == 0


def test_failed_batch_resolves_error_and_serving_goes_on():
    """A row whose preprocess raises resolves ``error`` alone once its
    retries are spent (the row is zero-filled at staging, as the
    reference's ``_stage_rows`` does); the other row of its batch and the
    next batch are served."""
    wl = port_workload("alexnet_imagenet")
    hook = wl.preprocess_hook

    def flaky(p):
        if p.shape[0] == 13:
            raise ValueError("corrupt image")
        return hook(p)
    server = wl.server(preprocess=flaky, max_batch=2, buckets=(1, 2))
    bad = [server.submit(np.zeros((s, 20, 3), np.uint8)) for s in (13, 20)]
    server.drain()
    ok = server.submit(np.zeros((20, 20, 3), np.uint8))
    server.drain()
    assert [r.outcome for r in bad] == ["error", "served"]
    assert "corrupt image" in bad[0].error
    assert bad[0].attempts == server.retry.max_attempts
    assert ok.outcome == "served"
    m = server.metrics()
    assert m["errors"] == 1 and m["served"] == 2 and m["queue_depth"] == 0
    assert m["retries"] == server.retry.max_attempts - 1
    assert m["degraded"] == 0         # a row's failure is not the bucket's


def test_deadline_sheds_and_counts():
    wl = port_workload("alexnet_imagenet")
    server = wl.server(max_batch=2, buckets=(1, 2), clock=lambda: 100.0)
    late = server.submit(np.zeros((16, 16, 3), np.uint8), deadline_s=1.0,
                         now=50.0)
    ok = server.submit(np.zeros((16, 16, 3), np.uint8))
    server.drain()
    assert late.outcome == "shed" and late.result is None
    assert ok.outcome == "served"
    assert server.metrics()["dropped"] == 1


def test_scheduler_matches_reference():
    from repro.serving import scheduler as j_sched
    from repro_torch.serving import scheduler as t_sched

    for mb in (1, 3, 8, 12, 16):
        assert t_sched.buckets_for(mb) == j_sched.buckets_for(mb)
    got = []
    for mod in (t_sched, j_sched):
        s = mod.BatchScheduler(max_batch=4, max_wait_s=1.0,
                               buckets=(1, 2, 4))
        for i in range(3):
            s.submit(np.full((2, 2), i + 1, np.uint8), now=0.0)
        assert not s.ready(now=0.5) and s.ready(now=1.0)
        batch, payloads = s.padded_batch(now=1.0)
        got.append((len(batch), np.stack(payloads)))
    assert got[0][0] == got[1][0] == 3
    np.testing.assert_array_equal(got[0][1], got[1][1])   # zero-filled row


# --------------------------------------------------------------------------
# Full-width lowering
# --------------------------------------------------------------------------

def zero_artifact(spec, input_hw, words, zeros, thresh):
    """Zero-filled packed arrays of the converter's shapes (no compute)."""
    h, w = input_hw
    c, flat, packed = None, False, []
    for layer in spec:
        kind = type(layer).__name__
        if kind == "BConv":
            cw = words(layer.c_in) * (8 if layer.first else 1)
            k = layer.kernel * layer.kernel * cw
            p = dict(w_packed=zeros((layer.c_out, k), "int32"),
                     thresh=thresh(layer.c_out))
            if layer.first:
                p["word_weights"] = zeros((k,), "int32")
            packed.append(p)
            h = (h + 2 * layer.pad - layer.kernel) // layer.stride + 1
            w = (w + 2 * layer.pad - layer.kernel) // layer.stride + 1
            c = layer.c_out
        elif kind == "Pool":
            h = (h + sum(layer.pad) - layer.window) // layer.stride + 1
            w = (w + sum(layer.pad) - layer.window) // layer.stride + 1
            packed.append({})
        elif kind == "BDense":
            k = words(layer.d_in) if flat else h * w * words(c)
            packed.append(dict(w_packed=zeros((layer.d_out, k), "int32"),
                               thresh=thresh(layer.d_out)))
            c, flat = layer.d_out, True
        else:
            shape = ((layer.d_in, layer.d_out) if kind == "FloatDense" else
                     (layer.kernel, layer.kernel, layer.c_in, layer.c_out))
            packed.append(dict(w=zeros(shape, "float32"),
                               b=zeros(shape[-1:], "float32"), c_per_pos=c))
    return packed


@pytest.mark.parametrize("net", ["alexnet", "yolov2-tiny", "vgg16"])
def test_full_width_lowering_matches_reference(net):
    import jax.numpy as jnp

    from repro.core import layer_integration as j_li
    from repro.core import packing as j_pack
    from repro_torch.core import layer_integration as t_li
    from repro_torch.core import packing as t_pack

    j_spec, (h, w, c) = j_nets.get(net)
    t_spec, t_shape = t_nets.get(net)
    assert t_spec == [getattr(t_bnn, type(l).__name__)(**vars(l))
                      for l in j_spec] and t_shape == (h, w, c)
    j_packed = zero_artifact(
        j_spec, (h, w), j_pack.num_words,
        lambda s, d: jnp.zeros(s, d),
        lambda o: j_li.IntegratedParams(jnp.zeros(o, jnp.int32),
                                        jnp.zeros(o, bool)))
    t_packed = zero_artifact(
        t_spec, (h, w), t_pack.num_words,
        lambda s, d: torch.zeros(s, dtype=getattr(torch, d)),
        lambda o: t_li.IntegratedParams(torch.zeros(o, dtype=torch.int32),
                                        torch.zeros(o, dtype=torch.bool)))
    jg = j_runtime.fuse_pool_epilogue(
        j_runtime.lower_packed(j_spec, j_packed, (h, w)))
    tg = fuse_pool_epilogue(lower_packed(t_spec, t_packed, (h, w)))
    assert sorted(jg.nodes) == sorted(tg.nodes)
    assert (jg.input_id, jg.output_id) == (tg.input_id, tg.output_id)
    for nid, jn in jg.nodes.items():
        tn = tg.nodes[nid]
        assert (tn.op, tn.inputs, tn.attrs) == (jn.op, jn.inputs, jn.attrs)
        assert set(tn.params) == set(jn.params)
        for k, v in jn.params.items():
            tv = tn.params[k]
            for a, b in (zip(tv, v) if isinstance(v, tuple) else [(tv, v)]):
                assert tuple(a.shape) == tuple(b.shape), (nid, k)
    jt = j_runtime.infer_types(jg, (8, h, w, c))
    tt = infer_types(tg, (8, h, w, c))
    for nid in jg.nodes:
        assert tt[nid].shape == jt[nid].shape, nid
        assert str(tt[nid].dtype).removeprefix("torch.") == \
            np.dtype(jt[nid].dtype).name
        assert tt[nid].nbytes == jt[nid].nbytes


def test_backend_report_follows_the_fallback_ladder():
    from repro_torch.runtime import GraphExecutor

    wl = port_workload("alexnet_imagenet", "cuda_direct_pool")
    exe = wl.engine.engine.compile(2)
    report = {(r["op"], r["backend"]) for r in exe.backend_report()}
    assert report == {("packed_conv_pool", "cuda_direct_pool"),
                      ("packed_dense", "cuda_popcount")}
    dense = next(r["node"] for r in exe.backend_report()
                 if r["op"] == "packed_dense")
    with pytest.raises(ValueError, match="does not apply"):
        GraphExecutor(exe.graph, {dense: "cuda_direct"})
    with pytest.raises(ValueError, match="unusable"):
        GraphExecutor(exe.graph, "xla")
    arrays, meta = wl.engine.engine.prepare()
    assert meta[-1] == {"c_per_pos": 64} and "c_per_pos" not in arrays[-1]


def test_entry_points_default_to_the_card():
    wl = t_workloads.get("alexnet_imagenet", variant="tiny",
                         params=reference("alexnet_imagenet")["params"])
    assert wl.device == "cuda" and wl.matmul_mode == "cuda_direct_pool"
    no_card = not torch.cuda.is_available()
    with (pytest.raises(RuntimeError, match="no CUDA device") if no_card
          else contextlib.nullcontext()):
        assert wl.engine.device.type == "cuda"


# --------------------------------------------------------------------------
# Box mapping, readable rows and the end-to-end convenience calls
# --------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw,out_hw", [((100, 50), (64, 64)),
                                          ((375, 500), (416, 416)),
                                          ((32, 32), (32, 32))])
def test_letterbox_boxes_as_reference(in_hw, out_hw):
    from repro.workloads import preprocess as j_pre
    from repro_torch.workloads import preprocess as t_pre

    rng = np.random.default_rng(harness.SEED)
    h, w = in_hw
    boxes = np.sort(rng.uniform(0, 1, (5, 2, 2)), axis=1).reshape(5, 4) \
        * np.array([w, h, w, h])
    fwd = t_pre.letterbox_boxes(boxes, in_hw, out_hw)
    np.testing.assert_array_equal(
        fwd, np.asarray(j_pre.letterbox_boxes(boxes, in_hw, out_hw)))
    # Network-frame boxes past the content map back clipped to the image.
    net = np.concatenate([fwd, [[-5, -5, out_hw[1] + 5, out_hw[0] + 5]]])
    back = t_pre.unletterbox_boxes(net, in_hw, out_hw)
    np.testing.assert_array_equal(
        back, np.asarray(j_pre.unletterbox_boxes(net, in_hw, out_hw)))
    np.testing.assert_allclose(back[:5], boxes, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", harness.CONFORMANCE_NAMES)
def test_predict_and_format_as_reference(name):
    """``predict`` on off-size images equals the JAX engine on the same
    network-size inputs (the preprocess hook's own parity is
    ``tests/test_torch_preprocess.py``'s), and ``format`` — with
    ``detections_to_dicts`` for detection — gives the reference's dicts
    for the same rows."""
    ref = reference(name)
    wl = port_workload(name, "cuda_direct_pool")
    with jax.threefry_partitionable(False):
        jwl = harness.conformance_workload(name)
    rng = np.random.default_rng(harness.SEED)
    imgs = [rng.integers(0, 256, (40 + 7 * i, 30 + 5 * i, 3),
                         dtype=np.uint8) for i in range(3)]
    got = wl.predict(imgs)
    x = np.stack([wl.preprocess_hook(im).numpy() for im in imgs])
    want = np.asarray(jwl.engine(x))
    assert_decoded_close(got, want, ref["task"])
    for row in want:
        mine, theirs = wl.format(row), jwl.format(row)
        assert mine == theirs
    if ref["task"] == "detect":
        from repro.workloads import postprocess as j_post
        from repro_torch.workloads import postprocess as t_post
        for row in want:
            assert t_post.detections_to_dicts(row, wl.detect) == \
                j_post.detections_to_dicts(row, jwl.detect)
        assert any(wl.format(row) for row in want)


def test_capture_needs_a_card():
    """On the CPU ``compile`` captures nothing; ``capture=True`` there is
    a ValueError (a CUDA graph needs the card)."""
    wl = port_workload("alexnet_imagenet")
    wl.engine(torch.zeros((1, 16, 16, 3), dtype=torch.uint8))
    assert wl.engine.capture_count == 0
    for eng in (wl.engine, wl.engine.engine):
        with pytest.raises(ValueError, match="capture=True needs a CUDA"):
            eng.compile(1, capture=True)
