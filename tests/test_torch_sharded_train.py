"""Port parity on a mesh: the sharded LM train step over gloo ranks.

The train step of the reference (``transformer.loss_fn`` and
``make_train_step`` under ``jax.jit`` over a ``(data, model)`` mesh, XLA
inserting every gradient collective) against the port's, which writes each
collective out as a differentiable op of ``distributed.sharding``.  One
module-scoped spawn of 4 gloo ranks (one thread a rank, a join timeout
``JOIN_S``, ``file://`` rendezvous) runs every rank-side case on a (2, 2)
mesh, then on a (1, 4) mesh over the same ranks; this process computes the
JAX side and the one-device port path and hands the ranks numpy arrays (the
ranks import no JAX).  Compared:

* (a) each differentiable collective's backward is its forward's transpose:
  ⟨f(x), y⟩ = ⟨x, fᵀ(y)⟩ summed over the ranks, a value replicated over
  ``copies`` ranks counted once (float64, to 1e-12 relative), for
  ``copy_to_model``, ``reduce_from_model``, ``gather_model``,
  ``split_model``, ``all_to_all``, ``pmean`` over ``model`` and
  ``gather_fsdp`` over ``data``; ``Collective`` refuses a tensor that
  requires grad; ``moe_apply``'s gradient with the tokens cut over
  ``model`` and not (every model rank routing the same tokens) against one
  device, float32, to ``F32_TOL``;
* (b) ``loss_fn`` and every gradient leaf, gathered, for minitron-8b SMOKE
  on (2, 2) and granite-moe-3b-a800m SMOKE (capacity factor 8: nothing
  drops) on (2, 2) and (1, 4), from the same padded numpy params, against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` on a (1, 1) mesh
  (jitted with ``xla_allow_excess_precision`` off, as
  ``tests/test_torch_train.py`` does) within its ``LOSS_TOL`` 5e-3 and
  ``GRAD_TOL`` 5e-2 relative L2, and against the port's one-device path
  within ``SINGLE_LOSS_TOL`` and ``SINGLE_GRAD_TOL``: the forward is the
  one-device forward bit for bit (a row-parallel product sums float32
  partials and rounds once), and the backward rounds each rank's bf16
  partial cotangent before the sum.  With float32 compute
  (``layers.COMPUTE_DTYPE``) the gradients equal the one-device ones to
  ``F32_TOL``: any misplaced collective moves a leaf by O(1) there.  On a
  mesh the MoE balance loss is the mean of each token shard's loss (the
  reference's ``_moe_local`` takes its ``pmean`` over the shards), not the
  loss of all the tokens at once: so the one-device sides (the reference
  on (1, 1) and the port's one-device path) run with ``moe_apply``'s
  balance loss taken over the same 4 contiguous token shards
  (``shard_aux``, patched in for this process only; no file of the JAX
  package changes), and the unpatched reference loss is held to
  ``LOSS_TOL`` as well;
* (c) three sharded ``make_train_step`` steps on (2, 2), both archs: the
  losses against the reference's steps (``LOSS_TOL``); against the
  one-device port's, step 0's loss within ``SINGLE_LOSS_TOL``, the later
  ones within ``STEP_LOSS_TOL`` and the gradient norms within
  ``NORM_TOL`` (AdamW's first update is the sign of each gradient
  element, so an element near 0 may step the other way); with float32
  compute the losses and norms within ``F32_TOL`` and the three steps'
  update of the gathered params within ``UPDATE_TOL`` relative L2 of the
  one-device update;
* (d) remat: minitron SMOKE under ``"dots"`` against ``"nothing"`` on
  (2, 2), loss and gradients bit for bit, and ``Collective.calls``
  counted: "dots" keeps each row-parallel product's output (the op
  ``repro_torch::row_parallel``), so its recompute makes exactly the
  2 · n_layers row-parallel sums fewer;
* (e) the driver under ``python -m torch.distributed.run --standalone
  --nproc-per-node 4 -m repro_torch.launch.train --device cpu --smoke
  --arch minitron-8b --data 2 --model 2``: every rank dies with 17 at
  ``--fail-at`` once the checkpoint is written; the rerun on the same mesh
  resumes with the uninterrupted run's losses and its last checkpoint
  (params and optimiser state) bit for bit; a
  rerun on ``--data 4 --model 1`` resumes within ``LOSS_TOL``; and a
  checkpoint padded for another expert count refuses to restore.
"""

import contextlib
import dataclasses
import os
import pathlib
import re
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.checkpoint import restore, save
from repro_torch.distributed import rules_for_mesh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Collective, gather
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt

REPO = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 300
LOSS_TOL = 5e-3          # tests/test_torch_train.py's
GRAD_TOL = 5e-2
SINGLE_LOSS_TOL = 1e-5   # sharded against the port's one-device path
SINGLE_GRAD_TOL = 2e-2
F32_TOL = 1e-5
NORM_TOL = 1e-2
STEP_LOSS_TOL = 2e-4
UPDATE_TOL = 1e-3
ADJOINT_TOL = 1e-12
BATCH, SEQ = 4, 32
SHARDS = 4               # token shards of the balance loss on both meshes
CASES = [("minitron-8b", (2, 2)), ("granite-moe-3b-a800m", (2, 2)),
         ("granite-moe-3b-a800m", (1, 4))]
STEP_ARCHS = ("minitron-8b", "granite-moe-3b-a800m")
LR = 1e-3


def smoke(arch):
    cfg = t_configs.get(arch).smoke
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)   # no drops
    return cfg


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def numpy_params(cfg, seed: int, ep: int) -> dict:
    """The reference's ``init_params`` tree for ``cfg`` at ``ep`` (its
    shapes and scales), drawn from a numpy seed, float32."""
    rng = np.random.default_rng(seed)
    lay = {}
    for name, shape, fan_in in t_tf._layer_shapes(cfg, ep):
        full = (cfg.n_layers, *shape)
        lay[name] = ((rng.standard_normal(full) / np.sqrt(fan_in))
                     if fan_in else np.ones(full)).astype(np.float32)
    out = {"embed": (rng.standard_normal((cfg.vocab, cfg.d_model))
                     * 0.02).astype(np.float32),
           "layers": lay, "final_norm": np.ones(cfg.d_model, np.float32)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (rng.standard_normal((cfg.d_model, cfg.vocab))
                          * 0.02).astype(np.float32)
    return out


def make_batch(rng, vocab):
    toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}


def rows(batch, rules):
    """The rank's rows of a numpy batch, as ``TokenPipeline(rules=)``
    places them."""
    n = BATCH // rules.dp
    lo = rules.coordinate(rules.batch) * n
    return {k: torch.from_numpy(v[lo:lo + n]) for k, v in batch.items()}


# --------------------------------------------------------------------------
# The ranks (no JAX)
# --------------------------------------------------------------------------

def adjoint_cases(rules, rank):
    """(name, ⟨f(x), y⟩, ⟨x, fᵀ(y)⟩) of each differentiable collective on
    this rank, each divided by the copies of a replicated value."""
    model, data = rules.comm("model"), rules.comm("data")
    tp = model.size

    def draw(shape, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g, dtype=torch.float64)

    row = rules.coordinate("data")        # shared by a model group
    ops = [  # name, f, x, y, copies of x, copies of f(x)
        ("copy_to_model", lambda x: sharding.copy_to_model(x, model),
         draw((3, 5), 10 + row), draw((3, 5), 20 + rank), tp, 1),
        ("reduce_from_model", lambda x: sharding.reduce_from_model(x, model),
         draw((3, 5), 30 + rank), draw((3, 5), 40 + row), 1, tp),
        ("gather_model", lambda x: sharding.gather_model(x, model, 1),
         draw((3, 4), 50 + rank), draw((3, 4 * tp), 60 + row), 1, tp),
        ("split_model", lambda x: sharding.split_model(x, model, 1),
         draw((3, 4 * tp), 70 + row), draw((3, 4), 80 + rank), tp, 1),
        ("all_to_all", lambda x: sharding.all_to_all(x, model, 0, 1),
         draw((2 * tp, 3, 2), 90 + rank), draw((2, 3 * tp, 2), 100 + rank),
         1, 1),
        ("pmean", lambda x: sharding.pmean(x, model),
         draw((), 110 + rank), draw((), 120 + row), 1, tp),
        ("gather_fsdp", lambda x: sharding.gather_fsdp(
            [x], [1], data)[0],
         draw((3, 4), 130 + rank), draw((3, 4 * data.size), 140 + rank), 1,
         1),
    ]
    out = []
    for name, f, x, y, cx, cy in ops:
        x = x.requires_grad_()
        fx = f(x)
        (g,) = torch.autograd.grad(fx, x, y)
        out.append((name, float((fx.detach() * y).sum()) / cy,
                    float((x.detach() * g).sum()) / cx))
    return out


def refusals(rules):
    """Each ``Collective`` op on a tensor that requires grad: its
    message."""
    model = rules.comm("model")
    x = torch.ones(4, 2, requires_grad=True)
    out = {}
    for name, call in (("psum", lambda: model.psum(x)),
                       ("all_gather", lambda: model.all_gather(x)),
                       ("all_to_all", lambda: model.all_to_all(x, 0, 1))):
        try:
            call()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


def float32_compute():
    """``layers.COMPUTE_DTYPE`` float32 inside the block."""
    return mock.patch.object(t_layers, "COMPUTE_DTYPE", torch.float32)


@float32_compute()
def moe_grads(rules, inp):
    """moe_apply's output and gradients (tokens, router, experts) on the
    rank's rows, tokens cut over ``model`` and not, float32 compute."""
    x, router, wg, wu, wd = map(torch.from_numpy, inp["moe"])
    n = x.shape[0] // rules.dp
    xs = x[rules.coordinate("data") * n:][:n]
    e = router.shape[1]
    specs = sharding.P("model", None, None)
    out = {}
    for taxes in (("data", "model"), ("data",)):
        leaves = [xs.clone(), router.clone()] + [
            sharding.local_shard(w, specs, rules).clone() for w in
            (wg, wu, wd)]
        for t in leaves:
            t.requires_grad_()
        y, aux = t_moe.moe_apply(
            leaves[0], leaves[1], *leaves[2:], n_experts=e, top_k=2,
            capacity_factor=float(e), act="swiglu", rules=rules,
            token_axes=taxes)
        part = (y * inp["moe_cot"][rules.coordinate("data") * n:][:n]).sum()
        loss = sharding.psum(part, rules.comm("data")) + 3.0 * aux
        grads = torch.autograd.grad(loss, leaves)
        router_g = rules.comm("data").psum(grads[1])
        experts = [gather(rules.comm("data").psum(g), specs, rules)
                   for g in grads[2:]]
        out[taxes] = (loss.item(), aux.item(),
                      rules.comm("data").all_gather(grads[0], 0), router_g,
                      experts)
    return out


def loss_and_grads(rules, arch, params_np, batch, f32: bool):
    cfg = smoke(arch)
    with float32_compute() if f32 else contextlib.nullcontext():
        params = t_tf.params_from_numpy(params_np, cfg, "cpu",
                                        dtype=torch.float32, ep=rules.tp,
                                        vocab_pad_to=rules.tp, rules=rules)
        specs = t_tf.param_specs(cfg, rules)
        (loss, parts), grads = tree.value_and_grad(
            t_tf.loss_fn, params, rows(batch, rules), cfg, rules)
        grads = sharding.sync_grads(grads, specs, rules)
    full = [gather(g, s, rules).numpy()
            for g, s in zip(tree.leaves(grads), tree.leaves(specs))]
    return float(loss), float(parts["aux"]), full


def train_steps(rules, arch, params_np, batches, f32: bool):
    cfg = smoke(arch)
    params = t_tf.params_from_numpy(params_np, cfg, "cpu",
                                    dtype=torch.float32, ep=rules.tp,
                                    vocab_pad_to=rules.tp, rules=rules)
    opt = t_opt.adamw_init(params)
    step = t_tf.make_train_step(cfg, rules,
                                lr=t_opt.cosine_schedule(LR, 1, 3))
    losses, norms = [], []
    with float32_compute() if f32 else contextlib.nullcontext():
        for batch in batches:
            params, opt, m = step(params, opt, rows(batch, rules))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    specs = t_tf.param_specs(cfg, rules)
    full = [gather(p, s, rules).numpy()
            for p, s in zip(tree.leaves(params), tree.leaves(specs))]
    return losses, norms, full, int(opt.step)


def remat_counts(rules, params_np, batch):
    """minitron SMOKE's loss and gradients under "nothing" and "dots", and
    the collective calls each makes."""
    out = {}
    for policy in ("nothing", "dots"):
        cfg = dataclasses.replace(smoke("minitron-8b"), remat_policy=policy)
        params = t_tf.params_from_numpy(params_np, cfg, "cpu",
                                        dtype=torch.float32, ep=rules.tp,
                                        vocab_pad_to=rules.tp, rules=rules)
        before = Collective.calls
        (loss, _), grads = tree.value_and_grad(
            t_tf.loss_fn, params, rows(batch, rules), cfg, rules)
        out[policy] = (Collective.calls - before, float(loss),
                       tree.leaves(grads))
    return out


def rank_main(rank, device, inp):
    out = {}
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device=device)
    rules = rules_for_mesh(mesh)
    out["adjoint"] = adjoint_cases(rules, rank)
    out["refusals"] = refusals(rules)
    out["moe"] = moe_grads(rules, inp)
    for arch, shape in CASES:
        if shape == (2, 2):
            out["case", arch, shape] = [
                loss_and_grads(rules, arch, inp["params", arch, shape],
                               inp["batch"], f32) for f32 in (False, True)]
    for arch in STEP_ARCHS:
        out["steps", arch] = [
            train_steps(rules, arch, inp["params", arch, (2, 2)],
                        inp["step_batches"], f32) for f32 in (False, True)]
    out["remat"] = remat_counts(rules, inp["params", "minitron-8b", (2, 2)],
                                inp["batch"])
    rules = rules_for_mesh(mesh_lib.make_host_mesh(data=1, model=4,
                                                   device=device))
    for arch, shape in CASES:
        if shape == (1, 4):
            out["case", arch, shape] = [
                loss_and_grads(rules, arch, inp["params", arch, shape],
                               inp["batch"], f32) for f32 in (False, True)]
    if rank:           # the leaves of rank 0 alone go back
        for key, val in out.items():
            if key[0] == "case":
                out[key] = [(loss, aux, None) for loss, aux, _ in val]
            if key[0] == "steps":
                out[key] = [v[:2] + (None, v[3]) for v in val]
    return out


# --------------------------------------------------------------------------
# This process: the balance loss over the mesh's token shards
# --------------------------------------------------------------------------

def t_shard_aux(x, router, n_experts, top_k, n):
    """The port's balance loss as a mesh takes it: the mean of each of
    ``n`` contiguous token shards' losses."""
    auxs = []
    for xs in x.reshape(n, -1, x.shape[-1]):
        _, ids, probs = t_moe._route(xs, router, n_real=n_experts,
                                     top_k=top_k)
        onehot = (ids[..., None] == torch.arange(router.shape[1])).float()
        auxs.append(n_experts * (onehot.sum(1).mean(0)
                                 * probs.mean(0)).sum())
    return torch.stack(auxs).mean()


def t_patched_moe(n):
    real = t_moe.moe_apply

    def moe_apply(x, router, wg, wu, wd, **kw):
        out, _ = real(x, router, wg, wu, wd, **kw)
        return out, t_shard_aux(x, router, kw["n_experts"], kw["top_k"], n)
    return mock.patch.object(t_moe, "moe_apply", moe_apply)


def j_patched_moe(n):
    import jax
    import jax.numpy as jnp

    from repro.models import moe as j_moe
    real = j_moe.moe_apply

    def moe_apply(x, router, wg, wu, wd, **kw):
        out, _ = real(x, router, wg, wu, wd, **kw)
        auxs = []
        for xs in x.reshape(n, -1, x.shape[-1]):
            _, ids, probs = j_moe._route(xs, router, n_real=kw["n_experts"],
                                         top_k=kw["top_k"])
            onehot = jax.nn.one_hot(ids, router.shape[1], dtype=jnp.float32)
            auxs.append(kw["n_experts"] * jnp.sum(
                jnp.mean(jnp.sum(onehot, axis=1), axis=0)
                * jnp.mean(probs, axis=0)))
        return out, jnp.mean(jnp.stack(auxs))
    return mock.patch.object(j_moe, "moe_apply", moe_apply)


def exact_jit(fn, *args):
    """``fn`` compiled with every bf16 intermediate rounded, as eager ops
    round them (``tests/test_torch_train.py``'s)."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(28)
    inp = {"batch": make_batch(rng, 256),
           "step_batches": [make_batch(rng, 256) for _ in range(3)]}
    for i, (arch, shape) in enumerate(CASES):
        inp["params", arch, shape] = numpy_params(smoke(arch), 40 + i,
                                                  ep=shape[1])
    t, d, e, fe = 64, 16, 8, 32
    inp["moe"] = (rng.standard_normal((t, d)).astype(np.float32),
                  (rng.standard_normal((d, e)) * 0.3).astype(np.float32),
                  *((rng.standard_normal((e, d, fe)) / np.sqrt(d))
                    .astype(np.float32) for _ in range(2)),
                  (rng.standard_normal((e, fe, d)) / np.sqrt(fe))
                  .astype(np.float32))
    inp["moe_cot"] = torch.from_numpy(
        rng.standard_normal((t, d)).astype(np.float32))
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return mesh_lib.spawn(rank_main, 4, inputs, device="cpu", threads=1,
                          timeout_s=JOIN_S,
                          workdir=str(tmp_path_factory.mktemp("train-mesh")))


@pytest.fixture(scope="module")
def jax_side(inputs):
    """The reference on a (1, 1) mesh: loss and gradients of each case
    (with the mesh's token-shard balance loss, and without), and three
    train steps' losses."""
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.distributed.sharding import rules_for_mesh as j_rules
    from repro.launch.mesh import make_host_mesh as j_mesh
    from repro.models import transformer as j_tf
    from repro.optim import optimizers as j_opt

    mesh = j_mesh(data=1, model=1)
    rules = j_rules(mesh)
    jb = jax.tree.map(jnp.asarray, inputs["batch"])
    out = {}
    with mesh:
        for arch, shape in CASES:
            cfg = dataclasses.replace(j_configs.get(arch).smoke,
                                      capacity_factor=smoke(arch)
                                      .capacity_factor)
            jp = jax.tree.map(jnp.asarray, inputs["params", arch, shape])
            vg = jax.value_and_grad(
                lambda p, b: j_tf.loss_fn(p, b, cfg, rules), has_aux=True)
            with j_patched_moe(SHARDS):
                (loss, _), grads = exact_jit(vg, jp, jb)(jp, jb)
            plain, _ = jax.jit(lambda p, b: j_tf.loss_fn(p, b, cfg, rules))(
                jp, jb)
            out["case", arch, shape] = (
                float(loss), [np.asarray(g, np.float32)
                              for g in jax.tree.leaves(grads)], float(plain))
        for arch in STEP_ARCHS:
            cfg = dataclasses.replace(j_configs.get(arch).smoke,
                                      capacity_factor=smoke(arch)
                                      .capacity_factor)
            jp = jax.tree.map(jnp.asarray,
                              inputs["params", arch, (2, 2)])
            js = j_opt.adamw_init(jp)
            step = j_tf.make_train_step(cfg, rules,
                                        lr=j_opt.cosine_schedule(LR, 1, 3))
            losses, fn = [], None
            with j_patched_moe(SHARDS):
                for batch in inputs["step_batches"]:
                    b = jax.tree.map(jnp.asarray, batch)
                    if fn is None:
                        fn = exact_jit(step, jp, js, b)
                    jp, js, m = fn(jp, js, b)
                    losses.append(float(m["loss"]))
            out["steps", arch] = losses
    return out


@pytest.fixture(scope="module")
def single(inputs):
    """The port's one-device path on the same params and batches (the
    balance loss over the mesh's token shards), bf16 and float32."""
    out = {}
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    with t_patched_moe(SHARDS):
        for arch, shape in CASES:
            cfg = smoke(arch)
            runs = []
            for f32 in (False, True):
                with (float32_compute() if f32
                      else contextlib.nullcontext()):
                    params = t_tf.params_from_numpy(
                        inputs["params", arch, shape], cfg, "cpu",
                        dtype=torch.float32, ep=shape[1],
                        vocab_pad_to=shape[1])
                    (loss, parts), grads = tree.value_and_grad(
                        t_tf.loss_fn, params, batch, cfg)
                runs.append((float(loss), float(parts["aux"]),
                             [g.numpy() for g in tree.leaves(grads)]))
            out["case", arch, shape] = runs
        for arch in STEP_ARCHS:
            cfg = smoke(arch)
            out["steps", arch] = []
            for f32 in (False, True):
                params = t_tf.params_from_numpy(
                    inputs["params", arch, (2, 2)], cfg, "cpu",
                    dtype=torch.float32, ep=2, vocab_pad_to=2)
                opt = t_opt.adamw_init(params)
                step = t_tf.make_train_step(
                    cfg, lr=t_opt.cosine_schedule(LR, 1, 3))
                losses, norms = [], []
                with (float32_compute() if f32
                      else contextlib.nullcontext()):
                    for b in inputs["step_batches"]:
                        params, opt, m = step(params, opt, {
                            k: torch.from_numpy(v) for k, v in b.items()})
                        losses.append(float(m["loss"]))
                        norms.append(float(m["grad_norm"]))
                out["steps", arch].append((losses, norms, [
                    p.numpy() for p in tree.leaves(params)]))
    return out


# --------------------------------------------------------------------------
# (a) the differentiable collectives
# --------------------------------------------------------------------------

def test_each_backward_is_its_forwards_transpose(ranks):
    names = [name for name, _, _ in ranks[0]["adjoint"]]
    assert len(names) == 7
    for i, name in enumerate(names):
        lhs = sum(r["adjoint"][i][1] for r in ranks)
        rhs = sum(r["adjoint"][i][2] for r in ranks)
        assert abs(lhs - rhs) <= ADJOINT_TOL * max(abs(lhs), 1.0), \
            (name, lhs, rhs)


def test_collective_refuses_a_tensor_that_requires_grad(ranks):
    want = {"psum": "reduce_from_model", "all_gather": "gather_fsdp",
            "all_to_all": "sharding.all_to_all"}
    for r in ranks:
        for op, message in r["refusals"].items():
            assert message is not None and "requires grad" in message, op
            assert want[op].split(".")[-1] in message, (op, message)


@pytest.mark.parametrize("taxes", [("data", "model"), ("data",)], ids=str)
def test_moe_gradients_whether_or_not_tokens_split(ranks, inputs, taxes):
    """The expert-parallel layer's gradients on (2, 2) against one device
    (float32): each data rank's tokens a batch shard, the balance loss the
    mean over the token shards (4 when the tokens are cut over ``model``,
    2 when every model rank routes the same tokens)."""
    x, router, wg, wu, wd = (torch.from_numpy(a).requires_grad_()
                             for a in inputs["moe"])
    e = router.shape[1]
    with float32_compute():
        y, _ = t_moe.moe_apply(x, router, wg, wu, wd, n_experts=e, top_k=2,
                               capacity_factor=float(e), act="swiglu")
    n = 4 if "model" in taxes else 2
    aux = t_shard_aux(x, router, e, 2, n)
    total = (y * inputs["moe_cot"]).sum() + 3.0 * aux
    want = torch.autograd.grad(total, (x, router, wg, wu, wd))
    loss, aux = total.item(), aux.item()
    for r in ranks:
        got_loss, got_aux, gx, grouter, gexperts = r["moe"][taxes]
        assert abs(got_loss - loss) <= F32_TOL * abs(loss)
        assert abs(got_aux - aux) <= F32_TOL * aux
        for g, w in zip([gx, grouter, *gexperts], want):
            assert rel_l2(g, w) <= F32_TOL, (taxes, rel_l2(g, w))


# --------------------------------------------------------------------------
# (b) loss_fn and the gradient leaves
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_sharded_loss_and_grads_match_reference(ranks, jax_side, single,
                                                arch, shape):
    key = ("case", arch, shape)
    (loss, aux, grads), (loss32, _, grads32) = ranks[0][key]
    for r in ranks[1:]:
        assert [x[:2] for x in r[key]] == [(loss, aux), (loss32, _)]
    want, want_grads, want_plain = jax_side[key]
    (one, one_aux, one_grads), (one32, _, one_grads32) = single[key]
    assert abs(loss - want) <= LOSS_TOL * abs(want)
    assert abs(loss - want_plain) <= LOSS_TOL * abs(want_plain)
    assert abs(loss - one) <= SINGLE_LOSS_TOL * abs(one)
    assert abs(aux - one_aux) <= SINGLE_LOSS_TOL * max(abs(one_aux), 1.0)
    assert abs(loss32 - one32) <= F32_TOL * abs(one32)
    paths = [p for p, _ in tree.flatten_with_paths(
        t_tf.abstract_params(smoke(arch), ep=shape[1],
                             vocab_pad_to=shape[1]))]
    for path, g, w, o, g32, o32 in zip(paths, grads, want_grads, one_grads,
                                       grads32, one_grads32):
        assert g.shape == w.shape == o.shape, path
        assert rel_l2(g, w) <= GRAD_TOL, (path, rel_l2(g, w))
        assert rel_l2(g, o) <= SINGLE_GRAD_TOL, (path, rel_l2(g, o))
        assert rel_l2(g32, o32) <= F32_TOL, (path, rel_l2(g32, o32))
    if smoke(arch).moe:
        assert aux > 0


# --------------------------------------------------------------------------
# (c) three train steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_train_steps(ranks, inputs, jax_side, single, arch):
    (losses, norms, params, step), (losses32, norms32, params32, _) = \
        ranks[0]["steps", arch]
    assert step == 3
    for r in ranks[1:]:
        assert [v[:2] for v in r["steps", arch]] == [(losses, norms),
                                                     (losses32, norms32)]
    for got, want in zip(losses, jax_side["steps", arch]):
        assert abs(got - want) <= LOSS_TOL * abs(want)
    (one_losses, one_norms, _), (one_losses32, one_norms32, one_params32) = \
        single["steps", arch]
    # bf16: step 0 is the one-device forward bit for bit; from step 1 the
    # params differ where AdamW's normalised update of a near-zero
    # gradient took the other sign.
    assert abs(losses[0] - one_losses[0]) <= SINGLE_LOSS_TOL * one_losses[0]
    for got, want in zip(losses[1:], one_losses[1:]):
        assert abs(got - want) <= STEP_LOSS_TOL * abs(want)
    for got, want in zip(norms, one_norms):
        assert abs(got - want) <= NORM_TOL * abs(want)
    # float32 compute: the three steps are the one-device ones
    for got, want in zip(losses32 + norms32, one_losses32 + one_norms32):
        assert abs(got - want) <= F32_TOL * abs(want)
    init = [p.numpy() for p in tree.leaves(t_tf.params_from_numpy(
        inputs["params", arch, (2, 2)], smoke(arch), "cpu",
        dtype=torch.float32, ep=2, vocab_pad_to=2))]
    err = rel_l2(np.concatenate([(p - i).ravel()
                                 for p, i in zip(params32, init)]),
                 np.concatenate([(o - i).ravel()
                                 for o, i in zip(one_params32, init)]))
    assert err <= UPDATE_TOL, err


# --------------------------------------------------------------------------
# (d) remat under rules
# --------------------------------------------------------------------------

def test_dots_keeps_the_row_parallel_sums(ranks):
    cfg = smoke("minitron-8b")
    for r in ranks:
        (n_calls, n_loss, n_grads) = r["remat"]["nothing"]
        (d_calls, d_loss, d_grads) = r["remat"]["dots"]
        assert d_loss == n_loss
        assert all(torch.equal(a, b) for a, b in zip(d_grads, n_grads))
        # wo and w_down a layer: summed in the forward, not again in the
        # "dots" recompute
        assert n_calls - d_calls == 2 * cfg.n_layers, (n_calls, d_calls)


# --------------------------------------------------------------------------
# (e) the driver under torchrun
# --------------------------------------------------------------------------

def torchrun(args, ckpt, out):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "--monitor-interval", "2", "-m",
           "repro_torch.launch.train", "--device", "cpu", "--smoke",
           "--arch", "minitron-8b", "--steps", "8", "--batch", "4",
           "--seq-len", "32", "--log-every", "1", "--checkpoint-every", "3",
           "--checkpoint-dir", str(ckpt), *args]
    return subprocess.Popen(cmd, env=env, stdout=open(out, "w"),
                            stderr=subprocess.STDOUT, text=True)


def losses_of(text):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^step\s+(\d+) loss (\S+)", text, re.M)}


def test_driver_crash_and_elastic_resume(tmp_path):
    mesh22 = ["--data", "2", "--model", "2"]
    logs = {k: tmp_path / f"{k}.log" for k in ("whole", "crash", "same",
                                                 "other")}
    runs = [torchrun(mesh22, tmp_path / "whole", logs["whole"]),
            torchrun(mesh22 + ["--fail-at", "4"], tmp_path / "crash",
                     logs["crash"])]
    rcs = [p.wait(timeout=300) for p in runs]
    crash = logs["crash"].read_text()
    assert rcs[0] == 0, logs["whole"].read_text()[-3000:]
    # torchrun reports each rank's exit code and exits non-zero itself
    assert rcs[1] != 0, crash[-3000:]
    assert "[fault injection] dying at step 4" in crash
    codes = re.findall(r"exitcode\s*:\s*(-?\d+)", crash)
    assert codes and set(codes) == {"17"}, codes
    assert sorted(os.listdir(tmp_path / "crash")) == ["step_2.npz"]
    shutil.copytree(tmp_path / "crash", tmp_path / "crash41")
    runs = [torchrun(mesh22, tmp_path / "crash", logs["same"]),
            torchrun(["--data", "4", "--model", "1"], tmp_path / "crash41",
                     logs["other"])]
    rcs = [p.wait(timeout=300) for p in runs]
    whole = losses_of(logs["whole"].read_text())
    for name, rc in zip(("same", "other"), rcs):
        text = logs[name].read_text()
        assert rc == 0, text[-3000:]
        assert "restored checkpoint at step 2; resuming from 3" in text
        got = losses_of(text)
        assert sorted(got) == list(range(3, 8))
        if name == "same":                  # bit for bit
            assert got == {s: whole[s] for s in range(3, 8)}
            with np.load(tmp_path / "whole" / "step_7.npz") as a, \
                    np.load(tmp_path / "crash" / "step_7.npz") as b:
                assert sorted(a.files) == sorted(b.files)
                for key in a.files:
                    np.testing.assert_array_equal(a[key], b[key], key)
        else:
            for s, v in got.items():
                assert abs(float(v) - float(whole[s])) \
                    <= LOSS_TOL * float(whole[s])
    assert "mesh data 4 x model 1" in logs["other"].read_text()
    assert len(losses_of(logs["crash"].read_text())) == 5


def test_restore_refuses_another_padding(tmp_path):
    """As the reference's restore: ``like`` holds the current mesh's
    padding, so a checkpoint padded for another expert count raises."""
    cfg = smoke("granite-moe-3b-a800m")
    params = t_tf.params_from_numpy(numpy_params(cfg, 3, ep=4), cfg, "cpu",
                                    dtype=torch.float32, ep=4)
    save(str(tmp_path), 1, params)
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 1, t_tf.abstract_params(
            cfg, ep=2, dtype=torch.float32))
