"""Port parity: K7 ``flash_attention``.

On a CPU tensor the port's wrapper runs its plain PyTorch version, the
blocked online softmax of the Pallas kernel's ``_kernel``.  It is held
against the Pallas kernel in interpret mode and against
``models.layers.chunked_attention`` of the JAX package, causal and not,
G = H / KV in {1, 4}, at several block shapes, with the tolerances of
``tests/test_flash_attention.py``: 2e-3 in float32, 5e-2 in bf16.  The
CUDA kernel is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import layers as j_layers
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import layers as t_layers

RNG = np.random.default_rng(7)
F32_TOL = 2e-3
BF16_TOL = 5e-2


def qkv(b, s, h, kvh, hd):
    return tuple(RNG.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kvh, hd),
                               (b, s, kvh, hd)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("block_q,block_k", [(32, 32), (64, 16)])
def test_plain_vs_pallas_and_chunked(causal, h, kvh, block_q, block_k):
    q, k, v = qkv(1, 64, h, kvh, 16)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal, block_q,
                          block_k).numpy()
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     block_q, block_k, True)
    chunked = j_layers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=block_q, kv_chunk=block_k)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got, np.asarray(chunked), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 384])
def test_plain_at_the_kernel_tiling_vs_pallas(causal, s):
    """The CUDA kernel's tiling, 128 q rows by 128 keys: several tiles a
    sweep, so the running max and sum carry across tiles."""
    q, k, v = qkv(1, s, 4, 2, 16)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal, 128, 128).numpy()
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     128, 128, True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_vs_pallas(causal):
    q, k, v = qkv(2, 64, 8, 2, 16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal, 32, 32)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                  for a in (tq, tk, tv))
    want = j_flash(jq, jk, jv, causal, 32, 32, True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_vs_reference_attention(causal):
    """Ragged-free but odd shapes: one block of 48 rows, hd 24, G = 3."""
    q, k, v = qkv(2, 48, 6, 2, 24)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal)
    want = j_layers.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    port = t_layers.reference_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_chunked_attention_goes_through_k7():
    """The port's ``chunked_attention`` is K7's call site: same result as
    the wrapper at the same blocks, and the reference's chunk contract."""
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 64, 4, 2, 8))
    got = t_layers.chunked_attention(q, k, v, causal=True, q_chunk=64,
                                     kv_chunk=32)
    assert torch.equal(got, flash_attention(q, k, v, True, 64, 32))
    with pytest.raises(ValueError, match="divide"):
        t_layers.chunked_attention(q, k, v, causal=True, q_chunk=48)


def test_shape_contract():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 64, 4, 2, 8))
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, k, v, True, 24, 32)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention(q, k[:, :32], v[:, :32], True, 32, 32)
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q[:, :, :3], k, v, False, 32, 32)
    # non-causal attention over a longer key sequence
    kl, vl = (torch.from_numpy(RNG.standard_normal((1, 128, 2, 8))
                               .astype(np.float32)) for _ in range(2))
    got = flash_attention(q, kl, vl, False, 32, 64)
    want = j_flash(jnp.asarray(q.numpy()), jnp.asarray(kl.numpy()),
                   jnp.asarray(vl.numpy()), False, 32, 64, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [128, 200])
def test_plain_at_head_width_64_vs_reference_attention(causal, s):
    """granite-moe-3b-a800m's head width, 64, at the kernel's tiling (a
    ragged second tile at S 200), G = 3: the plain version against the
    JAX package's and the port's ``reference_attention``."""
    q, k, v = qkv(1, s, 6, 2, 64)
    block = 128 if s % 128 == 0 else s
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                          block, block).numpy()
    want = j_layers.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    port = t_layers.reference_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hd", [32, 96, 256])
def test_kernel_refuses_other_head_widths(hd):
    """Off the CPU the wrapper takes bf16 at hd 64, 72, 80 or 128 only:
    other widths and float32 raise before any launch (checked on ``meta``
    tensors, which reach the kernel's contract without a card)."""
    q = torch.empty((1, 64, 4, hd), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=r"hd in \(64, 72, 80, 128\)"):
        flash_attention(q, q, q)
    for ok in (64, 72, 80, 128):
        q = torch.empty((1, 64, 4, ok), dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attention(q, q, q)
    q = torch.empty((1, 64, 4, 64), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q)
