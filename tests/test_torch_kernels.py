"""Port parity: the kernels' plain versions against the reference kernels.

K2 (fused_matmul_bn_binarize), K3 (direct_conv_bn_binarize) and K4
(bitplane_pack) — each port wrapper runs its plain PyTorch version for a
CPU tensor — held bit for bit against ``repro.kernels.ref`` and
``repro.kernels.ops`` in mode ``xla``.  K2 is also held against its Pallas
original in interpret mode.  K3's Pallas original does not run under the
installed jax (``pl.Unblocked`` is gone), so it is held against ``xla``.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import layer_integration as j_li
from repro.kernels import fused_conv_bn_binarize as j_fused
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core import bitplanes as t_planes
from repro_torch.core import layer_integration as t_li
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.bitplane_pack import bitplane_pack
from repro_torch.kernels.direct_conv_bn_binarize import \
    direct_conv_bn_binarize
from repro_torch.kernels.fused_conv_bn_binarize import \
    fused_matmul_bn_binarize

RNG = np.random.default_rng(5)


def words(*shape) -> np.ndarray:
    return RNG.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
        .astype(np.int32)


def epilogue(n: int, mean: float, spread: float):
    thr = RNG.integers(int(mean - spread), int(mean + spread) + 1,
                       n).astype(np.int32)
    return thr, RNG.integers(0, 2, n).astype(bool)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------

K2_CASES = [  # (M, N, W, weighted)
    (8, 64, 9, False),
    (13, 48, 7, True),          # N not a multiple of 32, plane weights
    (1, 96, 30, False),
]


@pytest.mark.parametrize("m,n,w,weighted", K2_CASES)
def test_k2_plain_matches_reference(m, n, w, weighted):
    a, b = words(m, w), words(n, w)
    ww = RNG.integers(1, 129, w).astype(np.int32) if weighted else None
    mean = 16.0 * (ww.sum() if weighted else w)
    thr, sgn = epilogue(n, mean, 3 * np.sqrt(8.0 * (
        (ww ** 2).sum() if weighted else w)))
    got = fused_matmul_bn_binarize(t(a), t(b), t(thr), t(sgn),
                                   None if ww is None else t(ww))
    assert got.dtype == torch.int32 and got.shape == (m, -(-n // 32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ref.fused_matmul_bn_binarize(
            a, b, thr, sgn, word_weights=ww)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ops.fused_matmul_bn_binarize(
            a, b, j_li.IntegratedParams(thr, sgn), word_weights=ww,
            mode="xla")))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_fused.fused_matmul_bn_binarize(
            a, b, thr, sgn, ww, block_m=8, block_n=32, block_k=8,
            interpret=True)))


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------

K3_CASES = [  # (name, (N, H, W, Cw), k, stride, pad, O, pool, first)
    ("3x3 pad 1", (2, 9, 8, 2), 3, 1, 1, 64, None, False),
    ("pool 2/2", (2, 10, 10, 1), 3, 1, 1, 32, (2, 2, (0, 0)), False),
    ("pool 3/2 O=48", (1, 13, 13, 3), 5, 1, 2, 48, (3, 2, (0, 0)), False),
    ("pool pad (0,1)", (2, 7, 7, 2), 3, 1, 1, 32, (2, 1, (0, 1)), False),
    ("stride 4 first", (2, 23, 23, 8), 7, 4, 0, 32, (3, 2, (0, 0)), True),
]


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_k3_plain_matches_xla(case):
    _, (n, h, w, cw), k, st, pad, o, pool, first = case
    x, wp = words(n, h, w, cw), words(o, k * k * cw)
    ww = (np.asarray(t_planes.plane_word_weights(cw // 8).repeat(k * k))
          if first else None)
    mean = 16.0 * (ww.sum() if first else k * k * cw)
    thr, sgn = epilogue(o, mean, 3 * np.sqrt(8.0 * (
        (ww.astype(np.int64) ** 2).sum() if first else k * k * cw)))
    got = direct_conv_bn_binarize(
        t(x), t(wp), t(thr), t(sgn), kh=k, kw=k, stride=st, pad=pad,
        word_weights=None if ww is None else t(ww), pool=pool)
    want = j_ops.fused_binary_conv2d(
        x, wp, j_li.IntegratedParams(thr, sgn), k, k, st, pad,
        word_weights=ww, mode="xla", pool=pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The port's im2col backends agree too, pool run after the conv.
    for mode in ("torch", "cuda_popcount"):
        alt = t_ops.fused_binary_conv2d(
            t(x), t(wp), t_li.IntegratedParams(t(thr), t(sgn)), k, k, st,
            pad, word_weights=None if ww is None else t(ww), mode=mode,
            pool=pool)
        np.testing.assert_array_equal(alt.numpy(), got.numpy())


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------

@pytest.mark.parametrize("c", [3, 40])
def test_k4_plain_matches_reference(c):
    x = RNG.integers(0, 256, (2, 6, 5, c), dtype=np.uint8)
    got = bitplane_pack(t(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_ref.bitplane_pack(x)))
    assert got.shape == (2, 6, 5, 8 * -(-c // 32))


def test_cpu_tensors_take_the_plain_path():
    """On the CPU a wrapper runs its plain version: no kernel launch."""
    before = (bitplane_pack.launches, fused_matmul_bn_binarize.launches,
              direct_conv_bn_binarize.launches)
    x = t(RNG.integers(0, 256, (1, 4, 4, 3), dtype=np.uint8))
    bitplane_pack(x)
    a, b = t(words(2, 3)), t(words(32, 3))
    thr, sgn = epilogue(32, 48, 10)
    fused_matmul_bn_binarize(a, b, t(thr), t(sgn))
    direct_conv_bn_binarize(t(words(1, 4, 4, 1)), t(words(32, 9)), t(thr),
                            t(sgn), kh=3, kw=3, pad=1)
    assert (bitplane_pack.launches, fused_matmul_bn_binarize.launches,
            direct_conv_bn_binarize.launches) == before


def test_unknown_modes_raise():
    a = t(words(2, 3))
    p = t_li.IntegratedParams(t(np.zeros(32, np.int32)),
                              t(np.zeros(32, bool)))
    with pytest.raises(ValueError):
        t_ops.fused_matmul_bn_binarize(a, t(words(32, 3)), p, mode="xla")
    with pytest.raises(ValueError):
        t_ops.fused_binary_conv2d(t(words(1, 4, 4, 1)), t(words(32, 9)), p,
                                  3, 3, mode="vpu_direct")


def test_backend_table_pairs_with_reference_modes():
    from repro.runtime.executor import ALL_MODES as J_ALL_MODES
    from repro.runtime.executor import CHAIN_BACKEND as J_CHAIN
    from repro_torch.runtime.executor import (ALL_MODES, BACKENDS,
                                              CHAIN_BACKEND, _FALLBACK)

    assert set(t_ops.JAX_MODE) == set(ALL_MODES)
    assert set(t_ops.JAX_MODE.values()) <= set(J_ALL_MODES)
    assert CHAIN_BACKEND not in BACKENDS
    assert t_ops.JAX_MODE[CHAIN_BACKEND] == J_CHAIN
    from repro.runtime.executor import _FALLBACK as J_FALLBACK
    for port, nxt in _FALLBACK.items():
        assert J_FALLBACK[t_ops.JAX_MODE[port]] == t_ops.JAX_MODE[nxt]
