"""Port parity: the MoE layer (``repro_torch.models.moe``) and the three LM
archs it completes (granite-moe-3b-a800m, qwen3-moe-30b-a3b, command-r-35b).

Both packages get the same numpy inputs; the JAX package runs on a
1-device host mesh (``make_host_mesh(data=1, model=1)``), where its
``moe_apply`` is the local path the port ports (no expert exchange).
Compared:

* ``capacity`` on the serving shapes, and ``_route``'s ids, ``_dispatch_
  indices``' destinations and keep mask **exactly**, at a capacity factor
  that drops (1.25) and at one that does not; ``_route``'s weights and
  probabilities within 1e-6 (float32 softmax: XLA's and PyTorch's ``exp``
  may differ in the last ulp, the routing decisions may not);
* ``moe_apply``'s output within ``MOE_TOL``: both sides bucket the same
  tokens and run the expert products in bf16, rounding at different
  points, so they agree to a few bf16 steps (2^-8 relative) of the
  output's scale; the aux loss within 1e-5;
* padding experts (5 real padded to 6) never picked, with no probability;
* ``moe_apply`` at a factor that drops nothing against the port's dense
  oracle ``moe_reference`` (the reference's own test's tolerance, 2e-2);
* ``forward`` logits and aux, and a prefill then decode ticks, for the
  granite-moe, qwen3-moe and command-r SMOKE configs against the JAX
  package within ``REL_TOL`` (``tests/test_torch_lm.py``'s 2e-2 relative
  max error), on the reference's ``init_params`` carried as numpy, one of
  them with the expert dim padded by ``ep=2``.  The reference is compiled
  with ``xla_allow_excess_precision`` off (:func:`exact_jit`), so that it
  rounds every bf16 intermediate as the port's eager ops do.  By default
  XLA skips the bf16 roundings inside a fusion, and at SMOKE size a top-k
  pick whose two probabilities lie 2e-4 apart flips under that rounding:
  qwen3-moe SMOKE's default-compiled ``forward_hidden`` differs by 1.1 in
  the hidden state from the same model compiled without the excess
  precision, which the port's equals;
* ``LMServer``'s tokens for qwen3-moe SMOKE against the reference
  ``LMServer``'s;
* the decode step with a device-tensor position (the captured step's
  form) against the int form, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro.serving.lm_server import LMServer as JLMServer
from repro_torch import configs as t_configs
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.serving.lm_server import LMServer

REL_TOL = 2e-2
MOE_TOL = 2e-2
ROUTE_TOL = 1e-6
PROMPT, MAX_SEQ = 24, 40
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
NEW_ARCHS = MOE_ARCHS + ("command-r-35b",)


@pytest.fixture(scope="module")
def mesh_rules():
    mesh = make_host_mesh(data=1, model=1)
    return mesh, rules_for_mesh(mesh)


def exact_jit(fn, *args):
    """``fn`` compiled with every bf16 intermediate rounded, as eager ops
    round them (XLA's ``xla_allow_excess_precision`` off)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def layer_inputs(seed, t, d, e, fe, router_scale=1.0):
    """Seeded numpy tokens, router and expert weights (the reference's
    test's scales)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            (rng.standard_normal((d, e)) * router_scale).astype(np.float32),
            (rng.standard_normal((e, d, fe)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((e, d, fe)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((e, fe, d)) / np.sqrt(fe)).astype(np.float32))


def as_torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def as_jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# --------------------------------------------------------------------------
# The layer's pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,e,factor", [
    (4, 8, 40, 1.25),        # granite, 4 decode slots: exactly 1.0
    (4, 8, 128, 1.25),       # qwen3, 4 decode slots
    (4096, 8, 128, 1.25),    # qwen3 prefill, B 2 x S 2048
    (4096, 8, 40, 1.25),     # granite prefill
    (2, 2, 8, 4.0), (64, 2, 5, 4.0), (7, 3, 6, 1.1), (1, 1, 48, 0.5),
    (96, 8, 48, 1.25),
])
def test_capacity_as_reference(t, k, e, factor):
    assert t_moe.capacity(t, k, e, factor) == j_moe.capacity(t, k, e, factor)
    assert t_moe.padded_experts(40, 16) == j_moe.padded_experts(40, 16) == 48


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("t,d,e,n_real,k", [
    (64, 16, 8, 8, 2), (48, 24, 6, 5, 2), (40, 32, 40, 40, 8)])
def test_route_and_dispatch_exact(t, d, e, n_real, k, factor):
    """The same ids, destinations and drops as the reference, at a
    capacity that drops (1.25) and one that does not (8)."""
    x, router, *_ = layer_inputs(t + e, t, d, e, 4)
    w, ids, probs = t_moe._route(*as_torch((x, router)), n_real=n_real,
                                 top_k=k)
    jw, jids, jprobs = j_moe._route(*as_jax((x, router)), n_real=n_real,
                                    top_k=k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               rtol=ROUTE_TOL, atol=ROUTE_TOL)
    cap = t_moe.capacity(t, k, e, factor)
    dest, keep = t_moe._dispatch_indices(ids, n_experts=e, cap=cap)
    jdest, jkeep = j_moe._dispatch_indices(jids, n_experts=e, cap=cap)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    kept = dest.numpy()[keep.numpy()]
    assert len(set(kept.tolist())) == len(kept) and (kept < e * cap).all()
    if factor == 8.0:
        assert keep.all()
    elif (t, k) == (64, 2):
        assert not keep.all()        # the Switch capacity drops here


def test_dispatch_drops_overflow_in_token_order():
    """Every token to expert 0 with capacity 3: the first three keep
    positions 0-2, the rest go to the sentinel, as the reference."""
    ids = np.zeros((10, 1), np.int64)
    dest, keep = t_moe._dispatch_indices(torch.from_numpy(ids),
                                         n_experts=4, cap=3)
    jdest, jkeep = j_moe._dispatch_indices(jnp.asarray(ids, jnp.int32),
                                           n_experts=4, cap=3)
    assert dest.tolist() == np.asarray(jdest).tolist() \
        == [0, 1, 2] + [12] * 7
    assert keep.tolist() == np.asarray(jkeep).tolist()


def test_padded_experts_never_picked():
    """5 real experts padded to 6: the sixth gets no token and no
    probability, on both sides."""
    x, router, *_ = layer_inputs(1, 32, 8, 6, 4)
    w, ids, probs = t_moe._route(*as_torch((x, router)), n_real=5, top_k=2)
    _, jids, _ = j_moe._route(*as_jax((x, router)), n_real=5, top_k=2)
    assert int(ids.max()) < 5
    assert float(probs[:, 5:].sum()) < 1e-6
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_moe_apply_as_reference(mesh_rules, act, factor):
    mesh, rules = mesh_rules
    t, d, e, k, fe = 64, 16, 8, 2, 32
    arrays = layer_inputs(3, t, d, e, fe, router_scale=0.1)
    got, aux = t_moe.moe_apply(*as_torch(arrays), n_experts=e, top_k=k,
                               capacity_factor=factor, act=act)
    with mesh:
        want, jaux = j_moe.moe_apply(*as_jax(arrays), n_experts=e, top_k=k,
                                     capacity_factor=factor, rules=rules,
                                     token_axes=(), act=act)
    assert got.shape == want.shape and got.dtype == torch.float32
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= MOE_TOL * scale
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_matches_the_dense_oracle_without_drops(dtype):
    """A factor of E: capacity T, nothing drops, and the bucketed layer
    equals the dense oracle (every expert on every token)."""
    t, d, e, k, fe = 64, 16, 8, 2, 32
    x, router, wg, wu, wd = as_torch(layer_inputs(0, t, d, e, fe, 0.1))
    x = x.to(dtype)
    got, _ = t_moe.moe_apply(x, router, wg, wu, wd, n_experts=e, top_k=k,
                             capacity_factor=float(e))
    want = t_moe.moe_reference(x, router, wg, wu, wd, n_experts=e, top_k=k)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# --------------------------------------------------------------------------
# The three archs' SMOKE configs through the model
# --------------------------------------------------------------------------

def smoke_params(arch, mesh_rules, ep=1, seed=0):
    """(reference config, reference params, port config, port params on
    the CPU) of ``arch``'s SMOKE."""
    mesh, _ = mesh_rules
    jcfg = j_configs.get(arch).smoke
    with mesh:
        jp = j_tf.init_params(jax.random.key(seed), jcfg, ep=ep)
    tcfg = t_configs.get(arch).smoke
    return jcfg, jp, tcfg, t_tf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.mark.parametrize("arch,ep", [(a, 1) for a in NEW_ARCHS]
                         + [("granite-moe-3b-a800m", 2)])
def test_forward_logits_and_aux(mesh_rules, arch, ep):
    mesh, rules = mesh_rules
    jcfg, jp, tcfg, tp = smoke_params(arch, mesh_rules, ep)
    if tcfg.moe:
        assert tp["layers"]["router"].dtype == torch.float32
        assert tp["layers"]["we_gate"].shape[1] == tcfg.padded_experts(ep)
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    with mesh:
        args = (jp, jnp.asarray(toks))
        want, jaux = exact_jit(
            lambda p, t: j_tf.forward(p, t, jcfg, rules), *args)(*args)
    got, aux = t_tf.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert rel_err(got, want) <= REL_TOL
    if tcfg.moe:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-3)
    else:
        assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode(mesh_rules, arch):
    mesh, rules = mesh_rules
    jcfg, jp, tcfg, tp = smoke_params(arch, mesh_rules)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    with mesh:
        args = (jp, jnp.asarray(toks))
        j_logits, j_cache = exact_jit(j_tf.make_prefill_step(
            jcfg, rules, MAX_SEQ), *args)(*args)
        j_decode = exact_jit(j_tf.make_decode_step(jcfg, rules, MAX_SEQ),
                             jp, j_cache, jnp.zeros((2, 1), jnp.int32),
                             jnp.int32(0))
    logits, cache = t_tf.make_prefill_step(tcfg, MAX_SEQ)(
        tp, torch.from_numpy(toks))
    assert rel_err(logits, j_logits) <= REL_TOL
    for name in ("k", "v"):
        assert rel_err(cache[name], j_cache[name]) <= REL_TOL
    decode = t_tf.make_decode_step(tcfg, MAX_SEQ)
    for pos in range(PROMPT, PROMPT + 3):
        tok = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        with mesh:
            j_logits, j_cache = j_decode(jp, j_cache, jnp.asarray(tok),
                                         jnp.int32(pos))
        logits, cache = decode(tp, cache, torch.from_numpy(tok), pos)
        assert rel_err(logits, j_logits) <= REL_TOL
        for name in ("k", "v"):
            assert rel_err(cache[name], j_cache[name]) <= REL_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_with_a_device_position(mesh_rules, arch):
    """An MoE decode step with ``pos`` as a 0-dim int64 tensor gives the
    int form's logits and cache bit for bit."""
    _, _, cfg, tp = smoke_params(arch, mesh_rules)
    decode = t_tf.make_decode_step(cfg, MAX_SEQ)
    by_int = t_tf.init_cache(cfg, 4, MAX_SEQ, "cpu")
    by_tensor = t_tf.init_cache(cfg, 4, MAX_SEQ, "cpu")
    rng = np.random.default_rng(13)
    for pos in (0, 1, 5, MAX_SEQ - 1):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1)))
        want, _ = decode(tp, by_int, tok, pos)
        got, _ = decode(tp, by_tensor, tok,
                        torch.tensor(pos, dtype=torch.int64))
        assert torch.equal(got, want)
        for name in ("k", "v"):
            assert torch.equal(by_tensor[name], by_int[name])


def test_lm_server_tokens_as_reference(mesh_rules):
    """qwen3-moe SMOKE through the port's and the reference's LMServer:
    requests joining mid-batch get the same tokens."""
    mesh, rules = mesh_rules
    jcfg, jp, tcfg, tp = smoke_params("qwen3-moe-30b-a3b",
                                      mesh_rules)
    rng = np.random.default_rng(14)
    reqs = [(list(rng.integers(1, tcfg.vocab, n)), m)
            for n, m in ((4, 3), (5, 5), (3, 4), (6, 2))]
    server = LMServer(tcfg, tp, n_slots=2, max_seq=48, device="cpu")
    got = [server.submit(p, max_new=m) for p, m in reqs]
    server.drain()
    with mesh:
        ref = JLMServer(cfg=jcfg, rules=rules, params=jp, n_slots=2,
                        max_seq=48)
        want = [ref.submit(p, max_new=m) for p, m in reqs]
        ref.drain()
    assert [r.outcome for r in got] == ["served"] * len(reqs)
    assert [r.result for r in got] == [r.result for r in want]
    assert server.pos == ref.pos


def test_init_params_shapes(mesh_rules):
    """The port's own draw has the reference's shapes at one device, a
    float32 router and bf16 experts (an expert dim padded by ``ep > 1``
    comes only from the reference, through ``params_from_numpy``)."""
    mesh, _ = mesh_rules
    for arch in NEW_ARCHS:
        cfg = t_configs.get(arch).smoke
        got = t_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with mesh:
            ref = j_tf.init_params(jax.random.key(0),
                                   j_configs.get(arch).smoke, ep=1)
        assert jax.tree.map(lambda t: tuple(t.shape), got) == \
            jax.tree.map(lambda a: tuple(a.shape), ref)
        if cfg.moe:
            lay = got["layers"]
            assert lay["router"].dtype == torch.float32
            assert lay["we_down"].dtype == torch.bfloat16
            # the reference's fan-ins: d for the router and the gate/up
            # stacks, d_ff_expert for the down stack
            assert abs(lay["we_down"].float().std().item()
                       - cfg.d_ff_expert ** -0.5) < 0.02
            assert abs(lay["router"].std().item()
                       - cfg.d_model ** -0.5) < 0.03


def test_blocked_draw_matches_the_whole_draw(monkeypatch):
    """The embedding drawn in row blocks has the whole draw's shape,
    scale and dtype (blocks of 1,000 elements here)."""
    cfg = dataclasses.replace(t_configs.get("command-r-35b").smoke,
                              n_layers=1)
    monkeypatch.setattr(t_tf, "_DRAW_ELEMENTS", 1000)
    p = t_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p["embed"].shape == (cfg.vocab, cfg.d_model)
    assert p["embed"].dtype == torch.bfloat16
    assert abs(p["embed"].float().std().item() - 0.02) < 0.002
    assert len(torch.unique(p["embed"][:, 0])) > cfg.vocab // 2
