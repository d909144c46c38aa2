"""Port parity: the count kernels K1 and K6 and the pm1 backends.

* K1 (``xnor_popcount_matmul``) and K6 (``mxu_pm1_matmul``): each port
  wrapper runs its plain PyTorch version for a CPU tensor, held bit for bit
  against the Pallas originals in interpret mode and ``repro.kernels.ref``.
* ``ops.matmul_counts`` and ``ops.binary_matmul_dot`` in every mode, and
  the pm1 count form of ``core.binary_ops``.
* The executor under ``torch_pm1`` / ``cuda_pm1`` (on the CPU) against the
  JAX executor under ``xla_pm1`` / ``mxu_pm1`` on the three tiny workloads:
  packed words exact, float heads within the harness's 1e-4; and the
  engine's ``cross_check`` under both pm1 modes, whose flat oracle takes
  the pm1 count form as the reference's does.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import harness
from repro import runtime as j_runtime
from repro.core import binary_conv as j_bconv
from repro.core import binary_ops as j_bops
from repro.core import converter as j_conv
from repro.core import layer_integration as j_li
from repro.kernels import mxu_pm1_matmul as j_k6
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import xnor_popcount_matmul as j_k1
from repro_torch import workloads as t_workloads
from repro_torch.core import binary_conv as t_conv
from repro_torch.core import binary_ops as t_bops
from repro_torch.core import bnn_model as t_bnn
from repro_torch.core import converter as t_convert
from repro_torch.core import layer_integration as t_li
from repro_torch.core import packing as t_pack
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.mxu_pm1_matmul import (mxu_pm1_matmul,
                                                mxu_pm1_matmul_plain)
from repro_torch.kernels.xnor_popcount_matmul import xnor_popcount_matmul
from repro_torch.runtime import GraphExecutor, lower_packed

RNG = np.random.default_rng(11)
PM1_MODES = {"torch_pm1": "xla_pm1", "cuda_pm1": "mxu_pm1"}


def words(*shape) -> np.ndarray:
    return RNG.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
        .astype(np.int32)


def channel_words(rows: int, channels: int, positions: int = 1
                  ) -> np.ndarray:
    """(rows, positions·num_words(channels)) words of random real bits,
    pad bits 0: what im2col of a packed map with ``channels`` gives."""
    bits = RNG.integers(0, 2, (rows, positions, channels))
    return np.asarray(t_pack.pack_bits(torch.from_numpy(bits), axis=-1)
                      .reshape(rows, -1))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------

K1_CASES = [  # (M, N, W, weighted)
    (13, 40, 7, False),
    (9, 33, 20, True),          # plane weights, N past one 32-column tile
    (70, 5, 3, True),           # M past one 64-row tile
]


@pytest.mark.parametrize("m,n,w,weighted", K1_CASES)
def test_k1_plain_matches_pallas(m, n, w, weighted):
    a, b = words(m, w), words(n, w)
    ww = RNG.integers(1, 129, w).astype(np.int32) if weighted else None
    got = xnor_popcount_matmul(t(a), t(b), None if ww is None else t(ww))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_k1.xnor_popcount_matmul(
            a, b, ww, block_m=8, block_n=8, block_k=8, interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ref.xnor_popcount_matmul(a, b, ww)))


# --------------------------------------------------------------------------
# K6
# --------------------------------------------------------------------------

K6_CASES = [  # (M, N, channels, positions): k_valid = channels·positions
    (10, 24, 64, 1),            # every bit real
    (7, 9, 16, 9),              # 16 pad bits in each of 9 words (YOLO conv2)
    (20, 40, 40, 3),            # 24 pad bits a position
    (3, 70, 1, 2),              # one real bit a word
]


@pytest.mark.parametrize("m,n,c,pos", K6_CASES)
def test_k6_plain_matches_pallas(m, n, c, pos):
    a, b = channel_words(m, c, pos), channel_words(n, c, pos)
    k_valid = c * pos
    got = mxu_pm1_matmul(t(a), t(b), k_valid)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_k6.mxu_pm1_matmul(
            a, b, k_valid=k_valid, block_m=8, block_n=8, block_k=4,
            interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ref.mxu_pm1_matmul(a, b, k_valid=k_valid)))


def test_k6_plain_is_exact_past_float32_slabs(monkeypatch):
    """The plain +-1 dot sums float32 slabs in int32: with the slab cut to
    2 words, a 7-word product still equals the xor form exactly."""
    monkeypatch.setattr(t_bops, "PM1_EXACT_WORDS", 2)
    a, b = words(5, 7), words(6, 7)
    np.testing.assert_array_equal(
        mxu_pm1_matmul_plain(t(a), t(b), 200).numpy(),
        np.asarray(j_ref.mxu_pm1_matmul(a, b, k_valid=200)))


@pytest.mark.parametrize("channels", [None, 50])
def test_core_mxu_pm1_matmul_matches_reference(channels):
    a, b = words(6, 2), words(5, 2)
    got = t_bops.mxu_pm1_matmul(t(a), t(b), 64, channels=channels)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_bops.mxu_pm1_matmul(a, b, 64,
                                                      channels=channels)))


# --------------------------------------------------------------------------
# Dispatch and the pm1 count form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_matmul_counts_every_mode(weighted):
    a, b = words(11, 6), words(35, 6)
    ww = RNG.integers(1, 129, 6).astype(np.int32) if weighted else None
    want = np.asarray(j_ops.matmul_counts(a, b, ww, mode="xla"))
    np.testing.assert_array_equal(
        want, np.asarray(j_ops.matmul_counts(a, b, ww, mode="vpu_popcount",
                                             block_m=8, block_n=8,
                                             block_k=8)))
    for mode in t_ops.COUNT_MODES:
        got = t_ops.matmul_counts(t(a), t(b), None if ww is None else t(ww),
                                  mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        t_ops.matmul_counts(t(a), t(b), mode="cuda_pm1")


def test_binary_matmul_dot_every_mode():
    a, b = channel_words(9, 40, 4), channel_words(17, 40, 4)
    k_valid = 160
    want = np.asarray(j_ops.binary_matmul_dot(a, b, k_valid, mode="xla"))
    for j_mode in ("vpu_popcount", "mxu_pm1"):
        np.testing.assert_array_equal(want, np.asarray(j_ops.binary_matmul_dot(
            a, b, k_valid, mode=j_mode, block_m=8, block_n=8, block_k=4)))
    for mode in t_ops.DOT_MODES:
        got = t_ops.binary_matmul_dot(t(a), t(b), k_valid, mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        t_ops.binary_matmul_dot(t(a), t(b), k_valid, mode="xla")


@pytest.mark.parametrize("weighted", [False, True])
def test_pm1_counts_match_reference(weighted):
    a, b = words(12, 5), words(9, 5)
    ww = RNG.integers(1, 129, 5).astype(np.int32) if weighted else None
    got = t_bops.packed_matmul_counts(t(a), t(b),
                                      None if ww is None else t(ww),
                                      impl="pm1")
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_bops.packed_matmul_counts(a, b, ww, impl="pm1")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_bops.packed_matmul_counts(a, b, ww)))


def test_pm1_counts_refuse_an_inexact_product(monkeypatch):
    """total - dot = 2·cnt is even for every exact +-1 product; a dot off by
    one (a rounded float sum) makes it odd, and the pm1 form says so
    instead of rounding."""
    a, b = words(3, 2), words(4, 2)
    exact = t_bops.pm1_dot(t(a), t(b))
    monkeypatch.setattr(t_bops, "pm1_dot", lambda *_: exact + 1)
    with pytest.raises(ArithmeticError, match="not exact"):
        t_bops.packed_matmul_counts(t(a), t(b), impl="pm1")


@pytest.mark.parametrize("mode", ["torch_pm1", "cuda_pm1"])
@pytest.mark.parametrize("pool", [None, (3, 2, (0, 0))])
def test_fused_conv_pm1_modes(mode, pool):
    """Conv + threshold + pack (+ OR-pool) under both pm1 modes: equal to
    JAX under the paired mode, first layer (weighted) and hidden layer."""
    for first in (False, True):
        cw = 8 if first else 2
        x = words(2, 9, 9, cw)
        wp = words(40, 9 * cw)
        ww = (np.tile(np.repeat(1 << np.arange(8), cw // 8), 9)
              .astype(np.int32) if first else None)
        # Centred on the mean count, 16 per word (times its weight).
        lo, hi = (34000, 39500) if first else (250, 330)
        thr = RNG.integers(lo, hi, 40).astype(np.int32)
        sgn = RNG.integers(0, 2, 40).astype(bool)
        got = t_ops.fused_binary_conv2d(
            t(x), t(wp), t_li.IntegratedParams(t(thr), t(sgn)), 3, 3, 1, 1,
            word_weights=None if ww is None else t(ww), mode=mode, pool=pool)
        want = j_ops.fused_binary_conv2d(
            x, wp, j_li.IntegratedParams(thr, sgn), 3, 3, 1, 1,
            word_weights=ww, mode=PM1_MODES[mode], pool=pool)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binary_conv2d_dot_and_final_float_dense():
    x, wp = words(1, 6, 5, 2), words(8, 18)
    got = t_conv.binary_conv2d_dot(t(x), t(wp), 576, 3, 3, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_bconv.binary_conv2d_dot(x, wp, 576, 3, 3, 1, 1)))
    w = RNG.standard_normal((50, 7)).astype(np.float32)
    b = RNG.standard_normal(7).astype(np.float32)
    xp = words(3, 2)
    np.testing.assert_allclose(
        t_conv.final_float_dense(t(xp), t(w), t(b), 50).numpy(),
        np.asarray(j_bconv.final_float_dense(xp, w, b, 50)), rtol=0,
        atol=1e-4)


# --------------------------------------------------------------------------
# The pm1 backends on the tiny workloads
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference(name: str, j_mode: str) -> dict:
    """The JAX side under one pm1 mode: params as numpy, the seeded input,
    the raw output, the packed tail of the executor's graph, and the raw
    output of the engine's flat oracle (the pm1 count form)."""
    with jax.threefry_partitionable(False):
        wl = harness.conformance_workload(name, matmul_mode=j_mode)
        params = [{k: np.asarray(v) for k, v in p.items()}
                  for p in wl.params]
    x = np.array(harness.seeded_batch(wl))
    cut = packed_cut(wl.spec)
    packed = j_conv.convert(wl.params, wl.spec, wl.input_hw)
    g = j_runtime.lower_packed(wl.spec[:cut], packed[:cut], wl.input_hw)
    return dict(params=params, x=x, raw=np.asarray(wl.engine.raw(x)),
                tail=np.asarray(j_runtime.GraphExecutor(g, j_mode)(x)),
                legacy=np.asarray(wl.engine.engine.legacy_call(x)))


def packed_cut(spec) -> int:
    cut = len(spec)
    while cut and type(spec[cut - 1]).__name__ in ("FloatDense",
                                                   "FloatConv"):
        cut -= 1
    return cut


def port_workload(name: str, mode: str):
    kw = dict(variant="tiny", device="cpu", matmul_mode=mode,
              params=reference(name, PM1_MODES[mode])["params"])
    if name == "yolov2_tiny_voc":
        kw["detect"] = t_workloads.DetectConfig(
            score_thresh=harness.CONFORMANCE_DETECT.score_thresh,
            iou_thresh=harness.CONFORMANCE_DETECT.iou_thresh,
            max_det=harness.CONFORMANCE_DETECT.max_det)
    return t_workloads.get(name, **kw)


@pytest.mark.parametrize("mode", sorted(PM1_MODES))
@pytest.mark.parametrize("name", harness.CONFORMANCE_NAMES)
def test_pm1_executor_matches_reference(name, mode):
    ref = reference(name, PM1_MODES[mode])
    wl = port_workload(name, mode)
    x = torch.from_numpy(ref["x"])
    cut = packed_cut(wl.spec)
    packed = t_convert.convert(wl.params, wl.spec, wl.input_hw)
    g = lower_packed(wl.spec[:cut], packed[:cut], wl.input_hw)
    exe = GraphExecutor(g, mode)
    assert {b for b in exe.backends.values()} == {mode}
    np.testing.assert_array_equal(exe(x).numpy(), ref["tail"])
    np.testing.assert_allclose(wl.engine.raw(x).numpy(), ref["raw"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", sorted(PM1_MODES))
@pytest.mark.parametrize("name", harness.CONFORMANCE_NAMES)
def test_pm1_engine_cross_check(name, mode):
    """``cross_check`` holds the graph path against the flat oracle, which
    under a pm1 mode takes the pm1 count form, as the reference's does."""
    ref = reference(name, PM1_MODES[mode])
    wl = port_workload(name, mode)
    x = torch.from_numpy(ref["x"])
    raw = wl.engine.engine.cross_check(x)
    np.testing.assert_allclose(raw.numpy(), ref["legacy"], rtol=0, atol=1e-4)
    calls = []
    orig = t_bops.packed_matmul_counts

    def spy(*a, **kw):
        calls.append(kw.get("impl", "xor"))
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_bops, "packed_matmul_counts", spy)
        wl.engine.engine.legacy_call(x)
    assert "pm1" in calls and set(calls) <= {"pm1", "xor"}


def test_pm1_oracle_matches_xor_oracle():
    """Both count forms give the same packed words: the pm1 oracle is the
    xor oracle's twin, not a looser one."""
    ref = reference("alexnet_imagenet", "mxu_pm1")
    wl = port_workload("alexnet_imagenet", "cuda_pm1")
    packed = t_convert.convert(wl.params, wl.spec, wl.input_hw)
    cut = packed_cut(wl.spec)
    x = torch.from_numpy(ref["x"])
    np.testing.assert_array_equal(
        t_bnn.packed_forward(packed[:cut], wl.spec[:cut], x, impl="pm1")
        .numpy(),
        t_bnn.packed_forward(packed[:cut], wl.spec[:cut], x).numpy())
