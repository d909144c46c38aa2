"""Port parity on a mesh: the sharded LM serving path over gloo ranks.

The counterparts of the reference's ``tests/test_distributed.py``
``test_moe_sharded_matches_reference``,
``test_elastic_restore_different_mesh`` and
``test_sharded_lm_matches_single_device``, plus the sharded prefill,
decode and ``LMServer``.  Ranks are processes: one module-scoped spawn of
8 gloo ranks on a (2, 4) mesh ``("data", "model")``, then one of 4 ranks
for the (4, 1) restore and the (1, 4) ``LMServer``, each with a
``file://`` rendezvous under a temporary directory, one thread a rank and
a join timeout (``JOIN_S``).  This process computes the JAX side and hands
the ranks numpy arrays; the ranks import no JAX (this module imports it
only inside the fixtures that run here).  Compared:

* ``moe_apply`` expert-parallel with ``token_axes`` ("data", "model") and
  ("data",) (tokens replicated over ``model``, the decode layout) against
  the reference's dense ``moe_reference`` at the reference test's 3e-2,
  and without its balance loss (the serving steps) bit-equal, with one
  collective fewer;
  the tiled ``all_to_all`` and ``all_gather`` against their definitions;
* the qwen3-moe-30b-a3b SMOKE forward (capacity factor 8: nothing drops)
  and the minitron-8b SMOKE forward against the reference's
  ``transformer.forward`` on a (1, 1) mesh and the one-device port, at the
  reference test's rtol 0.1, atol 0.25 and argmax agreement > 0.95; a
  batch of one row (whole over "data", its MoE tokens cut over both axes)
  and the (2, 2, 2) ``("pod", "data", "model")`` mesh over the same ranks
  against the one-device port;
* prefill into a sequence-sharded cache (48 positions, 12 a rank) and 4
  teacher-forced decode steps against the one-device port path and the
  reference's prefill and ``make_decode_step`` on a (1, 1) mesh: max
  |sharded - single| / max |single| <= 4e-2 (the chip smoke's bound) for
  the logits and the cache, argmax agreement >= 0.95;
* ``save`` on (2, 4), restored on (4, 1) and on one process (1, 1), bit
  for bit; a checkpoint the JAX package saved (granite SMOKE, ``ep=4``:
  5 experts padded to 8) restored onto (2, 4), each rank's slice bit for
  bit;
* a (1, 4) ``LMServer`` whose tokens equal the one-device server's on
  the same SMOKE weights, and again through decode faults that spend the
  retries: one restore from each rank's cache shard, the same tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.checkpoint import restore, save
from repro_torch.distributed import rules_for_mesh
from repro_torch.distributed.sharding import (Collective, P, gather,
                                              local_shard, shard_tree)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.serving import faults
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.lm_server import LMServer

JOIN_S = 240
MOE_TOL = 3e-2
FWD_RTOL, FWD_ATOL, AGREE = 0.1, 0.25, 0.95
DECODE_REL = 4e-2
PROMPT, MAX_SEQ, STEPS, BATCH = 32, 48, 4, 4
MOE_SHAPE = dict(t=64, d=16, e=8, k=2, fe=32)
SERVER_REQUESTS = [(8, 6), (5, 4), (12, 8), (3, 5)]
ARCHS = ("qwen3-moe-30b-a3b", "minitron-8b")


def smoke(arch):
    cfg = t_configs.get(arch).smoke
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)  # no drops
    return cfg


def rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def agreement(a, b) -> float:
    return float((np.asarray(a).argmax(-1)
                  == np.asarray(b).argmax(-1)).mean())


# --------------------------------------------------------------------------
# The ranks (no JAX)
# --------------------------------------------------------------------------

def collectives_case(rules):
    """Tiled all_to_all and all_gather over ``model`` on a tensor that
    names its rank and position."""
    m = rules.comm("model")
    x = (torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
         + 1000 * m.index)
    return {"a2a_0_1": m.all_to_all(x, 0, 1), "a2a_1_2": m.all_to_all(
        x, 1, 2), "gather_1": m.all_gather(x, 1),
        "psum": m.psum(x), "pmax": m.pmax(x)}


def rank_a(rank, device, inp, ckpt_dir):
    """8 ranks, (2, 4): MoE, forwards, prefill/decode, save, the JAX
    checkpoint."""
    mesh = mesh_lib.make_host_mesh(data=2, model=4, device=device)
    rules = rules_for_mesh(mesh)
    out = {"backend": mesh.backend, "staged": mesh.staged,
           "collectives": collectives_case(rules)}

    x, router, wg, wu, wd = map(torch.from_numpy, inp["moe"])
    experts = [local_shard(w, P("model", None, None), rules)
               for w in (wg, wu, wd)]
    for taxes in (("data", "model"), ("data",)):
        runs = []
        for want_aux in (True, False):
            sent = Collective.payload_bytes
            got, aux = t_moe.moe_apply(
                local_shard(x, P("data", None), rules), router, *experts,
                n_experts=MOE_SHAPE["e"], top_k=MOE_SHAPE["k"],
                capacity_factor=float(MOE_SHAPE["e"]), rules=rules,
                token_axes=taxes, want_aux=want_aux)
            runs.append((got, aux, Collective.payload_bytes - sent))
        out["moe", taxes] = gather(runs[0][0], P("data", None), rules)
        out["moe_aux", taxes] = runs

    tokens = torch.from_numpy(inp["tokens"])
    for arch in ARCHS:
        cfg = smoke(arch)
        params = t_tf.params_from_numpy(inp[arch], cfg, "cpu", rules=rules)
        out["forward", arch] = t_tf.forward(params, tokens, cfg,
                                            rules)[0].float()
        if arch == "qwen3-moe-30b-a3b":
            save(ckpt_dir, 3, params, rules, t_tf.param_specs(cfg, rules))
            # One row: whole over "data", while its 32 tokens split over
            # ("data", "model") for the MoE (tokens_spec).
            out["forward_row"] = t_tf.forward(params, tokens[:1], cfg,
                                              rules)[0].float()

    # The three-axis mesh: batch over ("pod", "data"), FSDP over "data".
    rules3 = rules_for_mesh(mesh_lib.make_host_mesh(pod=2, data=2, model=2,
                                                    device=device))
    cfg = smoke("qwen3-moe-30b-a3b")
    out["forward_pod"] = t_tf.forward(
        t_tf.params_from_numpy(inp["qwen3-moe-30b-a3b"], cfg, "cpu",
                               rules=rules3), tokens, cfg, rules3)[0].float()

    cfg = smoke("minitron-8b")
    params = t_tf.params_from_numpy(inp["minitron-8b"], cfg, "cpu",
                                    rules=rules)
    logits, cache = t_tf.make_prefill_step(cfg, MAX_SEQ, rules)(
        params, tokens[:, :PROMPT])
    specs = t_tf.cache_specs(cfg, rules, BATCH, MAX_SEQ)
    out["cache_shape"] = tuple(cache["k"].shape)
    out["prefill"] = (logits.float(),
                      {n: gather(c, specs[n], rules).float()
                       for n, c in cache.items()})
    decode = t_tf.make_decode_step(cfg, MAX_SEQ, rules)
    steps = []
    for i, pos in enumerate(range(PROMPT, PROMPT + STEPS)):
        logits, cache = decode(params, cache,
                               torch.from_numpy(inp["decode_tokens"][i]),
                               pos)
        steps.append(logits.float())
    out["decode"] = steps
    out["decode_cache"] = {n: gather(c, specs[n], rules).float()
                           for n, c in cache.items()}

    gcfg = t_configs.get("granite-moe-3b-a800m").smoke
    gspecs = t_tf.param_specs(gcfg, rules)
    got = restore(inp["jax_ckpt"], 5,
                  t_tf.abstract_params(gcfg, ep=4, dtype=torch.float32),
                  rules=rules, specs=gspecs)
    want = shard_tree(tree.tree_map(torch.from_numpy, inp["granite"]),
                      gspecs, rules)
    out["jax_ckpt_equal"] = [torch.equal(a, b) for a, b in
                             zip(tree.leaves(got), tree.leaves(want))]
    out["jax_ckpt_shapes"] = [tuple(a.shape) for a in tree.leaves(got)]
    return out


def rank_b(rank, device, inp, ckpt_dir):
    """4 ranks: the (2, 4) checkpoint restored on (4, 1), then a (1, 4)
    LMServer."""
    out = {}
    cfg = smoke("qwen3-moe-30b-a3b")
    rules = rules_for_mesh(mesh_lib.make_host_mesh(data=4, model=1,
                                                   device=device))
    specs = t_tf.param_specs(cfg, rules)
    got = restore(ckpt_dir, 3, t_tf.abstract_params(cfg, ep=4,
                                                    vocab_pad_to=4),
                  rules=rules, specs=specs)
    want = shard_tree(inp["qwen3_full"], specs, rules)
    out["restore_equal"] = [torch.equal(a, b) for a, b in
                            zip(tree.leaves(got), tree.leaves(want))]

    mcfg = smoke("minitron-8b")
    rules = rules_for_mesh(mesh_lib.make_host_mesh(data=1, model=4,
                                                   device=device))
    params = t_tf.params_from_numpy(inp["minitron-8b"], mcfg, "cpu",
                                    rules=rules)
    server = LMServer(mcfg, params, n_slots=2, max_seq=64, device=device,
                      rules=rules)
    reqs = [server.submit(p, max_new=m) for p, m in inp["requests"]]
    server.drain()
    out["server"] = ([r.outcome for r in reqs], [r.result for r in reqs],
                     server.pos, server.metrics()["served"])
    # The same requests through decode faults that spend the retries: a
    # restore from the last cut (each rank's cache shard) and its replay.
    server = LMServer(mcfg, params, n_slots=2, max_seq=64, device=device,
                      rules=rules, checkpoint_every=3)
    reqs = [server.submit(p, max_new=m) for p, m in inp["requests"]]
    with faults.inject(FaultPlan([FaultSpec("lm.step", "device_fault",
                                            times=4, after=2)])):
        server.drain()
    out["faulted"] = ([r.outcome for r in reqs], [r.result for r in reqs],
                      server.restores)
    return out


# --------------------------------------------------------------------------
# This process: the JAX side, the spawns
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.checkpoint import save as j_save
    from repro.distributed.sharding import rules_for_mesh as j_rules
    from repro.launch.mesh import make_host_mesh as j_mesh
    from repro.models import moe as j_moe
    from repro.models import transformer as j_tf

    mesh = j_mesh(data=1, model=1)
    rules = j_rules(mesh)
    rng = np.random.default_rng(17)
    s = MOE_SHAPE
    moe = (rng.standard_normal((s["t"], s["d"])).astype(np.float32),
           (rng.standard_normal((s["d"], s["e"])) * 0.1).astype(np.float32),
           *((rng.standard_normal((s["e"], s["d"], s["fe"]))
              / np.sqrt(s["d"])).astype(np.float32) for _ in range(2)),
           (rng.standard_normal((s["e"], s["fe"], s["d"]))
            / np.sqrt(s["fe"])).astype(np.float32))
    out = {"moe": moe,
           "moe_ref": np.asarray(j_moe.moe_reference(
               *map(jnp.asarray, moe), n_experts=s["e"], top_k=s["k"]),
               np.float32)}
    cfgs = {arch: smoke(arch) for arch in ARCHS}
    jcfgs = {arch: dataclasses.replace(
        j_configs.get(arch).smoke,
        capacity_factor=cfgs[arch].capacity_factor) for arch in ARCHS}
    out["tokens"] = rng.integers(0, 256, (BATCH, PROMPT)).astype(np.int32)
    out["decode_tokens"] = rng.integers(
        0, 256, (STEPS, BATCH, 1)).astype(np.int32)
    with mesh:
        for i, arch in enumerate(ARCHS):
            out[arch] = numpy_params(cfgs[arch], i, ep=4)
            out["forward_ref", arch] = np.asarray(jax.jit(
                lambda p, t, c=jcfgs[arch]: j_tf.forward(p, t, c, rules)[0])(
                    out[arch], jnp.asarray(out["tokens"])), np.float32)
        jcfg = jcfgs["minitron-8b"]
        jp = out["minitron-8b"]
        logits, cache = jax.jit(j_tf.make_prefill_step(
            jcfg, rules, MAX_SEQ))(jp, jnp.asarray(out["tokens"]))
        out["prefill_ref"] = np.asarray(logits, np.float32)
        decode = jax.jit(j_tf.make_decode_step(jcfg, rules, MAX_SEQ))
        steps = []
        for i, pos in enumerate(range(PROMPT, PROMPT + STEPS)):
            logits, cache = decode(jp, cache,
                                   jnp.asarray(out["decode_tokens"][i]),
                                   jnp.int32(pos))
            steps.append(np.asarray(logits, np.float32))
        out["decode_ref"] = steps
    gcfg = t_configs.get("granite-moe-3b-a800m").smoke
    gp = numpy_params(gcfg, 9, ep=4)
    # The reference's own tree of shapes (5 experts padded to 8).
    want = jax.tree.map(lambda a: a.shape, j_tf.abstract_params(
        j_configs.get("granite-moe-3b-a800m").smoke, ep=4))
    assert jax.tree.map(np.shape, gp) == want
    out["granite"] = gp
    out["jax_ckpt"] = str(tmp_path_factory.mktemp("jax-ckpt"))
    j_save(out["jax_ckpt"], 5, gp)
    return out


def numpy_params(cfg, seed: int, ep: int) -> dict:
    """The reference's ``init_params`` tree for ``cfg`` at ``ep`` (its
    shapes and scales: matrices N(0, 1/fan_in), embedding and head N(0,
    0.02²), norms 1), drawn from a numpy seed, float32."""
    rng = np.random.default_rng(seed)
    lay = {}
    for name, shape, fan_in in t_tf._layer_shapes(cfg, ep):
        full = (cfg.n_layers, *shape)
        lay[name] = ((rng.standard_normal(full) / np.sqrt(fan_in))
                     if fan_in else np.ones(full)).astype(np.float32)
    tree_ = {"embed": (rng.standard_normal((cfg.vocab, cfg.d_model))
                       * 0.02).astype(np.float32),
             "layers": lay,
             "final_norm": np.ones(cfg.d_model, np.float32)}
    if not cfg.tie_embeddings:
        tree_["lm_head"] = (rng.standard_normal((cfg.d_model, cfg.vocab))
                            * 0.02).astype(np.float32)
    return tree_


@pytest.fixture(scope="module")
def single(jax_side):
    """The one-device port path on the same weights and tokens."""
    out = {}
    tokens = torch.from_numpy(jax_side["tokens"])
    for arch in ARCHS:
        params = t_tf.params_from_numpy(jax_side[arch], smoke(arch), "cpu")
        out["forward", arch] = t_tf.forward(params, tokens,
                                            smoke(arch))[0].float()
        out["params", arch] = params
    out["forward_row"] = t_tf.forward(
        out["params", "qwen3-moe-30b-a3b"], tokens[:1],
        smoke("qwen3-moe-30b-a3b"))[0].float()
    cfg = smoke("minitron-8b")
    params = out["params", "minitron-8b"]
    logits, cache = t_tf.make_prefill_step(cfg, MAX_SEQ)(params, tokens)
    out["prefill"] = (logits.float(), {n: c.float().clone()
                                       for n, c in cache.items()})
    decode = t_tf.make_decode_step(cfg, MAX_SEQ)
    steps = []
    for i, pos in enumerate(range(PROMPT, PROMPT + STEPS)):
        logits, cache = decode(params, cache, torch.from_numpy(
            jax_side["decode_tokens"][i]), pos)
        steps.append(logits.float())
    out["decode"] = steps
    out["decode_cache"] = {n: c.float() for n, c in cache.items()}
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh-ckpt"))


@pytest.fixture(scope="module")
def ranks_a(jax_side, ckpt_dir, tmp_path_factory):
    inp = {k: v for k, v in jax_side.items() if not isinstance(k, tuple)}
    return mesh_lib.spawn(rank_a, 8, inp, ckpt_dir, device="cpu",
                          threads=1, timeout_s=JOIN_S,
                          workdir=str(tmp_path_factory.mktemp("mesh-a")))


@pytest.fixture(scope="module")
def ranks_b(ranks_a, jax_side, single, ckpt_dir, tmp_path_factory):
    rng = np.random.default_rng(23)
    inp = {"minitron-8b": jax_side["minitron-8b"],
           "qwen3_full": t_tf.params_from_numpy(
               jax_side["qwen3-moe-30b-a3b"], smoke("qwen3-moe-30b-a3b"),
               "cpu", vocab_pad_to=4),
           "requests": [([int(t) for t in rng.integers(1, 256, n)], m)
                        for n, m in SERVER_REQUESTS]}
    return inp, mesh_lib.spawn(
        rank_b, 4, inp, ckpt_dir, device="cpu", threads=1,
        timeout_s=JOIN_S, workdir=str(tmp_path_factory.mktemp("mesh-b")))


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------

def test_mesh_is_gloo_on_the_cpu(ranks_a):
    assert {(r["backend"], r["staged"]) for r in ranks_a} == {("gloo",
                                                               False)}


def test_collectives_as_defined(ranks_a):
    """Rank (d, m) of (2, 4): the model group is the 4 ranks of row d."""
    x = [torch.arange(96, dtype=torch.float32).reshape(4, 8, 3) + 1000 * m
         for m in range(4)]
    for r, out in enumerate(ranks_a):
        m = r % 4
        c = out["collectives"]
        assert torch.equal(c["a2a_0_1"], torch.cat(
            [x[j][m:m + 1] for j in range(4)], dim=1))
        assert torch.equal(c["a2a_1_2"], torch.cat(
            [x[j][:, 2 * m:2 * m + 2] for j in range(4)], dim=2))
        assert torch.equal(c["gather_1"], torch.cat(x, dim=1))
        assert torch.equal(c["psum"], sum(x))
        assert torch.equal(c["pmax"], x[3])


@pytest.mark.parametrize("taxes", [("data", "model"), ("data",)], ids=str)
def test_moe_sharded_matches_reference(ranks_a, jax_side, taxes):
    want = jax_side["moe_ref"]
    for out in ranks_a:
        np.testing.assert_allclose(out["moe", taxes].numpy(), want,
                                   rtol=MOE_TOL, atol=MOE_TOL)


@pytest.mark.parametrize("taxes", [("data", "model"), ("data",)], ids=str)
def test_moe_without_aux_makes_no_aux_collective(ranks_a, taxes):
    """``want_aux=False`` (the serving steps): the same output bit for bit,
    no balance loss, and 4 bytes (its float32 average) fewer handed to
    collectives; with it, the loss is the same on every rank."""
    auxs = set()
    for out in ranks_a:
        (got, aux, sent), (bare, none, sent_bare) = out["moe_aux", taxes]
        assert torch.equal(bare, got)
        assert none is None and aux.dtype == torch.float32
        assert sent - sent_bare == 4
        auxs.add(float(aux))
    assert len(auxs) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_reference(ranks_a, jax_side, single,
                                           arch):
    got = ranks_a[0]["forward", arch].numpy()
    for out in ranks_a[1:]:
        assert torch.equal(out["forward", arch], ranks_a[0]["forward",
                                                            arch])
    for want in (jax_side["forward_ref", arch],
                 single["forward", arch].numpy()):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
        assert agreement(got, want) > AGREE


def test_sharded_forward_of_one_row(ranks_a, single):
    """A batch of 1 on (2, 4): the row is whole over "data", its MoE
    tokens cut over ("data", "model") and put back."""
    got, want = ranks_a[0]["forward_row"], single["forward_row"]
    assert got.shape == want.shape == (1, PROMPT, 256)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    assert agreement(got, want) > AGREE
    for out in ranks_a[1:]:
        assert torch.equal(out["forward_row"], got)


def test_sharded_forward_on_the_three_axis_mesh(ranks_a, single):
    """(pod 2, data 2, model 2) over the same 8 ranks: the batch cut over
    ("pod", "data"), the weights over "data" and "model"."""
    got = ranks_a[0]["forward_pod"]
    want = single["forward", "qwen3-moe-30b-a3b"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    assert agreement(got, want) > AGREE
    for out in ranks_a[1:]:
        assert torch.equal(out["forward_pod"], got)


def test_sharded_prefill_fills_the_sequence_sharded_cache(ranks_a, single,
                                                          jax_side):
    cfg = smoke("minitron-8b")
    assert ranks_a[0]["cache_shape"] == (cfg.n_layers, BATCH // 2,
                                         cfg.n_kv_heads, MAX_SEQ // 4,
                                         cfg.d_head)
    logits, cache = ranks_a[0]["prefill"]
    want_logits, want_cache = single["prefill"]
    for want in (want_logits, jax_side["prefill_ref"]):
        assert rel(logits, want) <= DECODE_REL
        assert agreement(logits, want) >= AGREE
    for name in ("k", "v"):
        assert rel(cache[name], want_cache[name]) <= DECODE_REL
        assert not cache[name][:, :, :, PROMPT:].any()


def test_sharded_decode_matches_single_and_reference(ranks_a, single,
                                                     jax_side):
    got = torch.stack(ranks_a[0]["decode"])
    for out in ranks_a[1:]:
        assert torch.equal(torch.stack(out["decode"]), got)
    for want in (torch.stack(single["decode"]),
                 np.stack(jax_side["decode_ref"])):
        assert rel(got, want) <= DECODE_REL
        assert agreement(got, want) >= AGREE
    for name in ("k", "v"):
        assert rel(ranks_a[0]["decode_cache"][name],
                   single["decode_cache"][name]) <= DECODE_REL


def test_save_on_2x4_restores_on_one_process(ranks_a, single, ckpt_dir):
    cfg = smoke("qwen3-moe-30b-a3b")
    full = t_tf.params_from_numpy(
        {k: v for k, v in tree.tree_map(
            lambda t: t.float().numpy(),
            single["params", "qwen3-moe-30b-a3b"]).items()},
        cfg, "cpu", vocab_pad_to=4)
    mesh = mesh_lib.make_host_mesh(data=1, model=1, device="cpu")
    rules = rules_for_mesh(mesh)
    got = restore(ckpt_dir, 3, t_tf.abstract_params(cfg, ep=4,
                                                    vocab_pad_to=4),
                  rules=rules, specs=t_tf.param_specs(cfg, rules))
    for a, b in zip(tree.leaves(got), tree.leaves(full)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_save_on_2x4_restores_on_4x1(ranks_b):
    _, outs = ranks_b
    for out in outs:
        assert out["restore_equal"] and all(out["restore_equal"])


def test_jax_checkpoint_restores_onto_2x4(ranks_a):
    cfg = t_configs.get("granite-moe-3b-a800m").smoke
    for r, out in enumerate(ranks_a):
        assert all(out["jax_ckpt_equal"]) and out["jax_ckpt_equal"]
    shapes = dict(zip(
        [p for p, _ in tree.flatten_with_paths(
            t_tf.abstract_params(cfg, ep=4))], ranks_a[0]["jax_ckpt_shapes"]))
    # 5 experts padded to 8 by the reference, 2 a rank; d_model over data.
    assert shapes["['layers']['we_gate']"] == (cfg.n_layers, 2,
                                               cfg.d_model // 2,
                                               cfg.d_ff_expert)


def test_sharded_lm_server_tokens_equal_single_device(ranks_b, single):
    inp, outs = ranks_b
    cfg = smoke("minitron-8b")
    server = LMServer(cfg, single["params", "minitron-8b"], n_slots=2,
                      max_seq=64, device="cpu")
    reqs = [server.submit(p, max_new=m) for p, m in inp["requests"]]
    server.drain()
    want = ([r.outcome for r in reqs], [r.result for r in reqs],
            server.pos, server.metrics()["served"])
    assert want[0] == ["served"] * len(reqs)
    for out in outs:
        assert out["server"] == want


def test_sharded_lm_server_restores_through_a_fault(ranks_b):
    """(1, 4), ``checkpoint_every=3``, the same decode-fault plan on every
    rank: one restore from the cut of each rank's cache shard, and the
    tokens of the unfaulted sharded run."""
    _, outs = ranks_b
    for out in outs:
        outcomes, tokens, restores = out["faulted"]
        assert outcomes == ["served"] * len(SERVER_REQUESTS)
        assert tokens == out["server"][1]
        assert restores == 1
