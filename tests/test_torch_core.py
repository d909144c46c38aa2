"""Port parity: ``repro_torch.core`` against ``repro.core``.

The same numpy inputs go through the JAX function and its torch
counterpart; packed int32 words and integer thresholds must match bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary_conv as j_conv
from repro.core import binary_ops as j_ops
from repro.core import bitplanes as j_planes
from repro.core import layer_integration as j_li
from repro.core import packing as j_pack
from repro_torch.core import binary_conv as t_conv
from repro_torch.core import binary_ops as t_ops
from repro_torch.core import bitplanes as t_planes
from repro_torch.core import layer_integration as t_li
from repro_torch.core import packing as t_pack

RNG = np.random.default_rng(11)


def words(*shape) -> np.ndarray:
    return RNG.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64) \
        .astype(np.int32)


def same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 31, 32, 33, 40, 64, 100])
@pytest.mark.parametrize("axis", [-1, 1])
def test_pack_unpack_round_trip(channels, axis):
    bits = RNG.integers(0, 2, (3, channels, 5) if axis == 1
                        else (3, 5, channels)).astype(np.int32)
    bits[..., 0] = 1 if axis == -1 else bits[..., 0]
    if channels >= 32:                     # bit 31 set somewhere
        idx = [slice(None)] * 3
        idx[axis] = 31
        bits[tuple(idx)] = 1
    t_words = t_pack.pack_bits(torch.from_numpy(bits), axis=axis)
    assert t_words.dtype == torch.int32
    same(t_words, j_pack.pack_bits(jnp.asarray(bits), axis=axis))
    back = t_pack.unpack_bits(t_words, channels, axis=axis)
    np.testing.assert_array_equal(back.numpy(), bits)
    same(t_pack.unpack_to_pm1(t_words, channels, axis=axis,
                              dtype=torch.float32),
         j_pack.unpack_to_pm1(jnp.asarray(np.asarray(t_words)), channels,
                              axis=axis, dtype=jnp.float32))


def test_bit31_is_int32_min():
    bits = np.zeros((1, 32), np.int32)
    bits[0, 31] = 1
    assert t_pack.pack_bits(torch.from_numpy(bits)).item() == -2 ** 31


def test_pack_signs_matches():
    x = RNG.standard_normal((4, 37)).astype(np.float32)
    x[0, :5] = 0.0                                   # 0 counts as +1
    same(t_pack.pack_signs(torch.from_numpy(x)), j_pack.pack_signs(x))


def test_popcount_edges_and_random():
    edge = np.array([-2 ** 31, -1, 0, 1, 2 ** 31 - 1, 0x55555555,
                     -0x55555556], np.int32)
    got = t_pack.popcount(torch.from_numpy(edge)).numpy()
    np.testing.assert_array_equal(got, [1, 32, 0, 1, 31, 16, 16])
    w = words(1000)
    same(t_pack.popcount(torch.from_numpy(w)), j_pack.popcount(w))


# --------------------------------------------------------------------------
# bit-planes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("c", [3, 40])
def test_bitplanes_match(c):
    x = RNG.integers(0, 256, (2, 5, 4, c), dtype=np.uint8)
    same(t_planes.split_bitplanes(torch.from_numpy(x)),
         j_planes.split_bitplanes(x))
    same(t_planes.pack_bitplanes(torch.from_numpy(x)),
         j_planes.pack_bitplanes(x))
    cw = t_pack.num_words(c)
    same(t_planes.plane_word_weights(cw), j_planes.plane_word_weights(cw))


# --------------------------------------------------------------------------
# BN folding
# --------------------------------------------------------------------------

def _bn_at_boundary(o: int, k: int):
    """BN params whose xi puts (K - xi)/2 exactly on an integer (and, for
    half of them, exactly half-way), with gamma of both signs."""
    gamma = np.where(np.arange(o) % 2, -1.0, 1.0).astype(np.float32) \
        * RNG.uniform(0.5, 1.5, o).astype(np.float32)
    sigma = np.ones(o, np.float32)
    beta = np.zeros(o, np.float32)
    mu = (k - 2.0 * RNG.integers(0, k // 2, o)
          - (np.arange(o) % 4 >= 2)).astype(np.float32)   # xi = mu
    return gamma, beta, mu, sigma


def test_fold_bn_boundary_and_random():
    k = 27
    for gamma, beta, mu, sigma in (
            _bn_at_boundary(16, k),
            (RNG.uniform(-1.5, 1.5, 16).astype(np.float32),
             RNG.uniform(-1, 1, 16).astype(np.float32),
             RNG.uniform(-20, 20, 16).astype(np.float32),
             np.sqrt(RNG.uniform(0.5, 4, 16).astype(np.float32)
                     + np.float32(1e-4)))):
        t = t_li.fold_bn(k, *map(torch.from_numpy, (gamma, beta, mu, sigma)))
        j = j_li.fold_bn(k, gamma, beta, mu, sigma)
        same(t.threshold, j.threshold)
        same(t.sign_flip, j.sign_flip)
        # The integer epilogue equals the float BN oracle for every count.
        cnt = np.arange(k + 1, dtype=np.int32)[:, None]
        bits = t_li.apply_threshold(torch.from_numpy(cnt), t).numpy()
        ref = j_li.bn_reference(jnp.float32(k) - 2.0 * cnt, gamma, beta,
                                mu, sigma)
        np.testing.assert_array_equal(bits, np.asarray(ref))


def test_fold_bn_first_layer_boundary():
    k, o = 75, 12
    w_sum = (2 * RNG.integers(0, k + 1, o) - k).astype(np.float32)
    c1 = 255.0 * (k + w_sum) / 2.0
    gamma = np.where(np.arange(o) % 2, -1.0, 1.0).astype(np.float32)
    beta = np.zeros(o, np.float32)
    sigma = np.ones(o, np.float32)
    mu = (c1 - RNG.integers(0, 2000, o)).astype(np.float32)   # lim integral
    mu[::3] += 0.5
    t = t_li.fold_bn_first_layer(k, torch.from_numpy(w_sum),
                                 *map(torch.from_numpy,
                                      (gamma, beta, mu, sigma)))
    j = j_li.fold_bn_first_layer(k, w_sum, gamma, beta, mu, sigma)
    same(t.threshold, j.threshold)
    same(t.sign_flip, j.sign_flip)


# --------------------------------------------------------------------------
# counts, im2col, OR-pool
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_packed_matmul_counts_chunked(weighted, monkeypatch):
    a, b = words(37, 20), words(11, 20)
    ww = RNG.integers(0, 129, 20).astype(np.int32) if weighted else None
    want = j_ops.packed_matmul_counts(a, b, word_weights=ww)
    tww = None if ww is None else torch.from_numpy(ww)
    same(t_ops.packed_matmul_counts(torch.from_numpy(a), torch.from_numpy(b),
                                    tww), want)
    monkeypatch.setattr(t_ops, "CHUNK_ELEMS", 50)    # rows and words chunked
    same(t_ops.packed_matmul_counts(torch.from_numpy(a), torch.from_numpy(b),
                                    tww), want)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (5, 2, 2), (7, 4, 0)])
def test_im2col_matmul(k, stride, pad):
    x = words(2, 19, 15, 3)
    tp, tdims = t_conv.im2col_matmul(torch.from_numpy(x), k, k, stride, pad)
    jp, jdims = j_conv.im2col_matmul(x, k, k, stride, pad)
    assert tdims == jdims
    same(tp, jp)


@pytest.mark.parametrize("window,stride,pad", [(2, 2, (0, 0)),
                                               (3, 2, (0, 0)),
                                               (2, 1, (0, 1)),
                                               (3, 2, (1, 1))])
def test_binary_or_maxpool(window, stride, pad):
    x = words(2, 13, 11, 3)
    same(t_conv.binary_or_maxpool(torch.from_numpy(x), window, stride, pad),
         j_conv.binary_or_maxpool(x, window, stride, pad))


def test_pack_conv_weights_and_fused_conv():
    w = RNG.uniform(-1, 1, (3, 3, 40, 48)).astype(np.float32)
    same(t_conv.pack_conv_weights(torch.from_numpy(w)),
         j_conv.pack_conv_weights(w))
    x = words(2, 7, 6, 2)
    wp = np.array(j_conv.pack_conv_weights(w))
    p = j_li.IntegratedParams(RNG.integers(250, 330, 48).astype(np.int32),
                              RNG.integers(0, 2, 48).astype(bool))
    tp = t_li.IntegratedParams(torch.from_numpy(np.asarray(p.threshold)),
                               torch.from_numpy(np.asarray(p.sign_flip)))
    same(t_conv.binary_conv2d_fused(torch.from_numpy(x), torch.from_numpy(wp),
                                    tp, 3, 3, 1, 1),
         j_conv.binary_conv2d_fused(x, wp, p, 3, 3, 1, 1))


def test_no_jax_or_reference_import_in_port():
    """The port imports neither jax nor the reference package."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    files = list((root / "src" / "repro_torch").rglob("*.py")) \
        + [root / "chip_smoke.py"]
    bad = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|"
                     r"from repro\.|from repro import)", re.M)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert not offenders, offenders
    assert jax is not None
