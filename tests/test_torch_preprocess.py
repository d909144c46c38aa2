"""Port parity: preprocessing and postprocess heads against the JAX package.

Resizes: ``jax.image.resize(..., "bilinear")`` antialiases when it
downsamples, as ``F.interpolate(..., antialias=True)`` does.  The two
compute their interpolation weights by different float32 formulas, which
differ by ~1e-5 relative; on the 0-255 pixel range that reaches 4e-3
when upsampling 1.6x.  So the floats before rounding are held within
``RESIZE_ATOL`` = 1e-2 pixel units, and the uint8 outputs within 1 (a
value near .5 may round either way).

Heads: ``nms_fixed`` (including its stable compaction), ``topk_head``,
``decode_yolo`` and ``detect_head`` on random inputs (no exact score ties)
match at 1e-4, indices and validity masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.workloads import postprocess as j_post
from repro.workloads import preprocess as j_pre
from repro_torch.workloads import postprocess as t_post
from repro_torch.workloads import preprocess as t_pre

RNG = np.random.default_rng(17)
RESIZE_ATOL = 1e-2
SIZES = [((100, 50), (64, 64)), ((37, 81), (32, 32)), ((20, 30), (64, 48)),
         ((416, 300), (416, 416))]


def _jax_letterbox_float(img, out_hw):
    h, w, c = img.shape
    _, (top, left), (nh, nw) = j_pre.letterbox_params((h, w), out_hw)
    r = jax.image.resize(jnp.asarray(img, jnp.float32), (nh, nw, c),
                         method="bilinear")
    canvas = np.full(out_hw + (c,), float(j_pre.LETTERBOX_FILL), np.float32)
    canvas[top:top + nh, left:left + nw] = np.asarray(r)
    return canvas


def _jax_center_crop_float(img, out_hw):
    h, w, c = img.shape
    oh, ow = out_hw
    short = -(-max(oh, ow) * 8 // 7)
    scale = short / min(h, w)
    nh, nw = max(int(round(h * scale)), oh), max(int(round(w * scale)), ow)
    r = np.asarray(jax.image.resize(jnp.asarray(img, jnp.float32),
                                    (nh, nw, c), method="bilinear"))
    top, left = (nh - oh) // 2, (nw - ow) // 2
    return r[top:top + oh, left:left + ow]


@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_letterbox_matches_reference(in_hw, out_hw):
    img = RNG.integers(0, 256, in_hw + (3,), dtype=np.uint8)
    assert t_pre.letterbox_params(in_hw, out_hw) == \
        j_pre.letterbox_params(in_hw, out_hw)
    np.testing.assert_allclose(
        t_pre.letterbox_float(torch.from_numpy(img), out_hw).numpy(),
        _jax_letterbox_float(img, out_hw), rtol=0, atol=RESIZE_ATOL)
    got = t_pre.letterbox(torch.from_numpy(img), out_hw).numpy()
    want = np.asarray(j_pre.letterbox(jnp.asarray(img), out_hw))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_center_crop_matches_reference(in_hw, out_hw):
    img = RNG.integers(0, 256, in_hw + (3,), dtype=np.uint8)
    np.testing.assert_allclose(
        t_pre.center_crop_float(torch.from_numpy(img), out_hw).numpy(),
        _jax_center_crop_float(img, out_hw), rtol=0, atol=RESIZE_ATOL)
    got = t_pre.center_crop_resize(torch.from_numpy(img), out_hw).numpy()
    want = np.asarray(j_pre.center_crop_resize(jnp.asarray(img), out_hw))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_server_hook_is_contiguous_uint8():
    hook = t_pre.as_server_hook(
        lambda x: t_pre.center_crop_resize(x, (16, 16)), device="cpu")
    img = RNG.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    out = hook(img)
    assert out.shape == (16, 16, 3) and out.dtype == torch.uint8
    assert out.device.type == "cpu" and out.is_contiguous()
    assert torch.equal(out, t_pre.center_crop_resize(torch.from_numpy(img),
                                                     (16, 16)))


# --------------------------------------------------------------------------
# Heads
# --------------------------------------------------------------------------

def test_topk_head_matches_reference():
    logits = RNG.standard_normal((3, 10)).astype(np.float32) * 3
    got = t_post.topk_head(torch.from_numpy(logits), 5).numpy()
    want = np.asarray(j_post.topk_head(jnp.asarray(logits), 5))
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _boxes(m: int) -> np.ndarray:
    xy = RNG.uniform(0, 50, (m, 2))
    wh = RNG.uniform(2, 25, (m, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("m,classes,score_thresh", [
    (30, False, 0.0), (30, True, 0.0), (40, True, 0.4), (5, False, 0.0)])
def test_nms_fixed_matches_reference(m, classes, score_thresh):
    boxes = _boxes(m)
    # Clustered boxes so suppression really happens.
    boxes[m // 2:] = boxes[: m - m // 2] + RNG.uniform(
        -1, 1, (m - m // 2, 4)).astype(np.float32)
    scores = RNG.uniform(0, 1, m).astype(np.float32)
    scores[:3] = 0.0                       # zero scores never survive
    cls = RNG.integers(0, 3, m).astype(np.int32) if classes else None
    kw = dict(iou_thresh=0.3, score_thresh=score_thresh, max_det=8)
    got = t_post.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                           None if cls is None else torch.from_numpy(cls),
                           **kw).numpy()
    want = np.asarray(j_post.nms_fixed(
        jnp.asarray(boxes), jnp.asarray(scores),
        None if cls is None else jnp.asarray(cls), **kw))
    assert got.shape == (8, 6)
    np.testing.assert_array_equal(got[:, 4] > 0, want[:, 4] > 0)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # Stable compaction: survivors first, score-descending, zeros after.
    valid = got[:, 4] > 0
    assert not valid[np.argmin(valid):].any() or valid.all()
    assert (np.diff(got[valid, 4]) <= 0).all()


def test_iou_matrix_matches_reference():
    a, b = _boxes(6), _boxes(4)
    a[0] = [5, 5, 5, 9]                    # zero-area box: IoU 0
    np.testing.assert_allclose(
        t_post.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_post.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)


def test_decode_and_detect_head_match_reference():
    j_cfg = j_post.DetectConfig(score_thresh=0.05, max_det=8)
    t_cfg = t_post.DetectConfig(score_thresh=0.05, max_det=8)
    feat = (RNG.standard_normal((2, 5, 5, j_cfg.channels)) * 2) \
        .astype(np.float32)
    tb, ts, tc = t_post.decode_yolo(torch.from_numpy(feat), t_cfg, (80, 80))
    jb, js, jc = j_post.decode_yolo(jnp.asarray(feat), j_cfg, (80, 80))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got = t_post.detect_head(torch.from_numpy(feat), t_cfg, (80, 80)).numpy()
    want = np.asarray(j_post.detect_head(jnp.asarray(feat), j_cfg, (80, 80)))
    assert (got[..., 4] > 0).any()
    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
