"""Port parity: the training path — K7's backward (K7b), STE training of a
BNN and its deployment, the LM loss and train step, and the train driver.

Both packages get the same numpy inputs and parameters.  What each case
holds, and why:

* ``flash_attention_bwd_plain`` (K7b's plain version) against autograd of
  the port's float32 ``reference_attention`` and against ``jax.vjp`` of the
  reference's ``chunked_attention``, causal and not, GQA, two block sizes,
  within ``ATTN_TOL``: float32 throughout, the sums in other orders;
  ``flash_attention`` under autograd on the CPU runs the Function (plain
  forward with lse, plain backward) and gives the same gradients, and
  without autograd the same output, with no kernel launch;
* ``bnn_model.float_forward(train=True)``: the loss and every gradient on
  the tiny spec of ``tests/test_bnn_engine.py`` against
  ``jax.value_and_grad`` (loss within 1e-5 relative, each gradient within
  ``GRAD_F32_TOL`` relative L2: the signs are exact, the float32 convs and
  matmuls sum in other orders); three AdamW steps with
  ``clip_latent_paths`` against the reference's (``PARAM_TOL``); then
  ``PhoneBitEngine.from_trained`` under ``torch`` equal to the float oracle
  (argmax 100%, the head within 1e-3, the packed engine's own bound in
  ``tests/test_bnn_engine.py``);
* the LM ``loss_fn`` and its gradients on minitron-8b SMOKE and
  granite-moe-3b-a800m SMOKE (the MoE balance loss included) from the
  reference's params as float32 masters, against ``jax.value_and_grad`` of
  the reference's ``loss_fn``: the loss within ``LOSS_TOL`` (5e-3
  relative) and each leaf's gradient within ``GRAD_TOL`` (5e-2 relative
  L2).  Both compute in bf16 and round at different points (the reference
  jitted with ``xla_allow_excess_precision`` off, as
  ``tests/test_torch_moe.py`` compiles it, so its bf16 roundings are the
  eager ones), which moves the logits by a few bf16 steps (2^-8) and a
  gradient by a few percent of its norm; three ``make_train_step`` steps'
  losses against the reference's within ``LOSS_TOL``;
* the train driver: ``python -m repro_torch.launch.train --device cpu`` dies
  with exit code 17 at ``--fail-at 6`` and the rerun restores step 5 and
  resumes from 6 (``tests/test_system.py``'s case); its losses from 6 on
  equal an uninterrupted run's; ``--device cuda`` without a card raises;
  a mesh that is not the world's size (``--data 2`` or ``--model 2`` in
  one process) and a non-LM arch are refused.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn_model as j_bnn
from repro.core.bnn_model import BConv as JBConv, BDense as JBDense
from repro.core.bnn_model import FloatDense as JFloatDense, Pool as JPool
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.optim import optimizers as j_opt
from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.core import bnn_model as t_bnn
from repro_torch.kernels import flash_attention as k7
from repro_torch.launch import train as t_train
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.optim import optimizers as t_opt
from repro_torch.serving import PhoneBitEngine

REPO = pathlib.Path(__file__).resolve().parents[1]
ATTN_TOL = 2e-5
GRAD_F32_TOL = 1e-4
PARAM_TOL = 1e-5
LOSS_TOL = 5e-3
GRAD_TOL = 5e-2


def rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# --------------------------------------------------------------------------
# K7b's plain version
# --------------------------------------------------------------------------

ATTN_CASES = [  # (B, S, H, KV, hd, block_q, block_k, causal)
    (2, 64, 4, 2, 16, 16, 32, True),
    (2, 64, 4, 2, 16, 64, 64, True),
    (1, 48, 6, 2, 8, 16, 48, False),
    (2, 32, 4, 4, 8, 32, 16, False),
    # K7b's tile ratio, block_q : block_k = 1 : 2 (64 q rows to 128 keys
    # on the card): four q blocks over two key blocks, causal and not
    (2, 128, 4, 2, 16, 32, 64, True),
    (1, 96, 4, 2, 8, 16, 32, False),
    # a ragged S, a multiple of neither block: both cut to S = 40, as the
    # kernel's 64-row and 128-key tiles are cut at S < 64
    (2, 40, 4, 2, 16, 64, 128, True),
    (1, 40, 6, 3, 8, 64, 128, False),
    # G = 4 at the 1 : 2 ratio
    (1, 64, 8, 2, 16, 16, 32, True),
    (2, 64, 16, 4, 8, 32, 64, False),
]


def attn_inputs(case, seed=0):
    b, s, h, kvh, hd = case[:5]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kvh, hd),
                               (b, s, kvh, hd), (b, s, h, hd)))


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: f"S{c[1]}-bq{c[5]}-bk{c[6]}-"
                         f"{'causal' if c[7] else 'full'}")
def test_attention_backward_plain(case):
    bq, bk, causal = case[5:]
    q, k, v, do = attn_inputs(case)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = k7.flash_attention_plain(tq, tk, tv, causal, bq, bk,
                                        return_lse=True)
    got = k7.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal,
                                       bq, bk)
    # autograd of the port's float32 oracle
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref = t_layers.reference_attention(*leaves, causal=causal)
    want = torch.autograd.grad(ref, leaves, tdo)
    # jax.vjp of the reference's chunked attention at the same blocks
    _, vjp = jax.vjp(lambda a, b_, c: j_layers.chunked_attention(
        a, b_, c, causal=causal, q_chunk=bq, kv_chunk=bk), q, k, v)
    j_want = vjp(jnp.asarray(do))
    for g, w, jw in zip(got, want, j_want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
    # the Function on the CPU: plain forward with lse, plain backward
    before = (k7.flash_attention.launches, k7.flash_attention_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = k7.flash_attention(*leaves, causal, bq, bk)
    assert o.grad_fn is not None
    torch.testing.assert_close(o.detach(), out, rtol=0, atol=0)
    via = torch.autograd.grad(o, leaves, tdo)
    for g, w in zip(via, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with torch.no_grad():
        plain = k7.flash_attention(*leaves, causal, bq, bk)
    assert plain.grad_fn is None and torch.equal(plain, out)
    assert (k7.flash_attention.launches,
            k7.flash_attention_bwd.launches) == before


def test_attention_backward_bf16_rounds_like_the_kernel():
    """In bf16, p and dS are rounded to bf16 before their products, as K7b
    rounds them: the plain version stays within a few bf16 steps of the
    float32 gradient."""
    case = ATTN_CASES[0]
    q, k, v, do = (torch.from_numpy(a) for a in attn_inputs(case, seed=3))
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    out, lse = k7.flash_attention_plain(qb, kb, vb, True, return_lse=True)
    got = k7.flash_attention_bwd_plain(qb, kb, vb, out, lse, dob, True)
    leaves = [t.float().requires_grad_() for t in (qb, kb, vb)]
    want = torch.autograd.grad(
        t_layers.reference_attention(*leaves, causal=True), leaves,
        dob.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert ((g.float() - w).abs() <= 2e-2 * (1 + w.abs())).all()


# --------------------------------------------------------------------------
# BNN: STE training, then deployment
# --------------------------------------------------------------------------

def tiny_specs():
    """``tests/test_bnn_engine.py``'s tiny net in both packages."""
    j = [JBConv(3, 16, kernel=3, stride=1, pad=1, first=True), JPool(2, 2),
         JBConv(16, 40, kernel=3, stride=1, pad=1), JPool(2, 2),
         JBDense(4 * 4 * 40, 64), JFloatDense(64, 10)]
    t = [t_bnn.BConv(3, 16, kernel=3, stride=1, pad=1, first=True),
         t_bnn.Pool(2, 2), t_bnn.BConv(16, 40, kernel=3, stride=1, pad=1),
         t_bnn.Pool(2, 2), t_bnn.BDense(4 * 4 * 40, 64),
         t_bnn.FloatDense(64, 10)]
    return j, t


@pytest.fixture(scope="module")
def bnn():
    """Numpy latent params with non-trivial BN stats (the engine test's
    ranges), a batch of images and labels."""
    j_spec, t_spec = tiny_specs()
    rng = np.random.default_rng(42)
    params = [{k: v.numpy() for k, v in p.items()}
              for p in t_bnn.init_params(rng, t_spec)]
    for p in params:
        if "mu" in p:
            o = p["mu"].shape[0]
            p["mu"] = rng.uniform(-20, 20, o).astype(np.float32)
            p["var"] = rng.uniform(0.5, 4, o).astype(np.float32)
            p["gamma"] = rng.uniform(-1.5, 1.5, o).astype(np.float32)
            p["beta"] = rng.uniform(-1, 1, o).astype(np.float32)
    x = rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    y = rng.integers(0, 10, (8,)).astype(np.int32)
    return j_spec, t_spec, params, x, y


def j_bnn_loss(spec):
    def loss(p, x, y):
        logits = j_bnn.float_forward(p, spec, x, train=True)
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
        return jnp.mean(lse - gold)
    return loss


def t_bnn_loss(spec):
    def loss(p, x, y):
        logits = t_bnn.float_forward(p, spec, x, train=True)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, y.long()[:, None], dim=-1)[:, 0]
        return (lse - gold).mean(), None
    return loss


def test_bnn_train_forward_and_gradients(bnn):
    j_spec, t_spec, params, x, y = bnn
    want, j_grads = jax.value_and_grad(j_bnn_loss(j_spec))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y))
    t_params = tree.tree_map(torch.from_numpy, params)
    (got, _), t_grads = tree.value_and_grad(
        t_bnn_loss(t_spec), t_params, torch.from_numpy(x),
        torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # the values are those of the inference oracle
    np.testing.assert_array_equal(
        t_bnn.float_forward(t_params, t_spec, torch.from_numpy(x),
                            train=True).detach().numpy(),
        t_bnn.float_forward(t_params, t_spec, torch.from_numpy(x)).numpy())
    for (path, g), w in zip(tree.flatten_with_paths(t_grads),
                            jax.tree.leaves(j_grads)):
        assert rel_l2(g, w) <= GRAD_F32_TOL, path
    assert float(t_grads[0]["w"].abs().sum()) > 0      # the STE passes


def test_bnn_adamw_steps_then_deploy(bnn):
    j_spec, t_spec, params, x, y = bnn
    clip = lambda path: "w" in path       # noqa: E731 (train_bnn.py's)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree.tree_map(torch.from_numpy, params)
    js, ts = j_opt.adamw_init(jp), t_opt.adamw_init(tp)
    j_lr = j_opt.cosine_schedule(1e-2, 1, 3)
    t_lr = t_opt.cosine_schedule(1e-2, 1, 3)
    j_loss, t_loss = j_bnn_loss(j_spec), t_bnn_loss(t_spec)
    for _ in range(3):
        _, jg = jax.value_and_grad(j_loss)(jp, jnp.asarray(x), jnp.asarray(y))
        jp, js, _ = j_opt.adamw_update(jp, jg, js, lr=j_lr, weight_decay=0.0,
                                       clip_latent_paths=clip)
        _, tg = tree.value_and_grad(t_loss, tp, torch.from_numpy(x),
                                    torch.from_numpy(y))
        tp, ts, _ = t_opt.adamw_update(tp, tg, ts, lr=t_lr, weight_decay=0.0,
                                       clip_latent_paths=clip)
    for (path, g), w in zip(tree.flatten_with_paths(tp),
                            jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=path)
    assert float(tp[0]["w"].abs().max()) <= 1.0
    # deployment: the packed engine on the CPU against the float oracle
    engine = PhoneBitEngine.from_trained(tp, t_spec, (16, 16), device="cpu",
                                         matmul_mode="torch")
    rng = np.random.default_rng(9)
    xs = torch.from_numpy(rng.integers(0, 256, (16, 16, 16, 3))
                          .astype(np.uint8))
    head = engine(xs)
    oracle = t_bnn.float_forward(tp, t_spec, xs)
    assert torch.equal(head.argmax(-1), oracle.argmax(-1))
    np.testing.assert_allclose(head.numpy(), oracle.detach().numpy(),
                               rtol=0, atol=1e-3)


# --------------------------------------------------------------------------
# LM: loss, gradients, train step
# --------------------------------------------------------------------------

LM_ARCHS = ("minitron-8b", "granite-moe-3b-a800m")


@pytest.fixture(scope="module")
def mesh_rules():
    mesh = make_host_mesh(data=1, model=1)
    return mesh, rules_for_mesh(mesh)


def exact_jit(fn, *args):
    """``fn`` compiled with every bf16 intermediate rounded, as eager ops
    round them (``tests/test_torch_moe.py``'s)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


def lm_case(arch, mesh, seed=0, b=2, s=32):
    from repro import configs as j_configs
    j_cfg = j_configs.get(arch).smoke
    t_cfg = t_configs.get(arch).smoke
    with mesh:
        jp = j_tf.init_params(jax.random.key(seed), j_cfg)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg, "cpu",
                                dtype=torch.float32)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, j_cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return j_cfg, t_cfg, jp, tp, batch


def t_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 5, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (2, 5)).astype(np.int32)
    want = j_tf.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                              z_loss)
    got = t_tf.cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels), z_loss)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_gradients(arch, mesh_rules):
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp, batch = lm_case(arch, mesh)
    jb = jax.tree.map(jnp.asarray, batch)
    with mesh:
        fn = exact_jit(jax.value_and_grad(
            lambda p, b: j_tf.loss_fn(p, b, j_cfg, rules), has_aux=True),
            jp, jb)
        (want, want_parts), j_grads = fn(jp, jb)
    (got, parts), t_grads = tree.value_and_grad(t_tf.loss_fn, tp,
                                                t_batch(batch), t_cfg)
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    np.testing.assert_allclose(parts["aux"].item(), float(want_parts["aux"]),
                               rtol=LOSS_TOL, atol=1e-6)
    if t_cfg.moe:
        assert parts["aux"].item() > 0
    for (path, g), w in zip(tree.flatten_with_paths(t_grads),
                            jax.tree.leaves(j_grads)):
        assert g.dtype == torch.float32 and g.shape == w.shape, path
        assert rel_l2(g, w) <= GRAD_TOL, (path, rel_l2(g, w))
    if t_cfg.moe:                          # the balance loss reaches it
        assert float(t_grads["layers"]["router"].abs().sum()) > 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_steps(arch, mesh_rules):
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp, _ = lm_case(arch, mesh, seed=1)
    j_lr = j_opt.cosine_schedule(1e-3, 1, 3)
    t_lr = t_opt.cosine_schedule(1e-3, 1, 3)
    j_step = j_tf.make_train_step(j_cfg, rules, lr=j_lr)
    t_step = t_tf.make_train_step(t_cfg, lr=t_lr)
    js, ts = j_opt.adamw_init(jp), t_opt.adamw_init(tp)
    rng = np.random.default_rng(11)
    with mesh:
        j_fn = None
        for _ in range(3):
            toks = rng.integers(0, j_cfg.vocab, (2, 33)).astype(np.int32)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            jb = jax.tree.map(jnp.asarray, batch)
            if j_fn is None:
                j_fn = exact_jit(j_step, jp, js, jb)
            jp, js, jm = j_fn(jp, js, jb)
            tp, ts, tm = t_step(tp, ts, t_batch(batch))
            want = float(jm["loss"])
            assert abs(tm["loss"].item() - want) <= LOSS_TOL * abs(want)
            np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                       rtol=1e-6)
    assert int(ts.step) == 3
    assert all(t.dtype == torch.float32 for t in tree.leaves(tp))


def test_serving_params_stay_bf16_and_ordinary():
    """The serving entry points keep their dtypes; params are ordinary
    tensors (not inference tensors), so autograd can save them."""
    cfg = t_configs.get("minitron-8b").smoke
    p = t_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p["layers"]["wq"].dtype == torch.bfloat16
    assert p["layers"]["ln1"].dtype == torch.float32
    assert not any(t.is_inference() for t in tree.leaves(p))
    toks = torch.randint(0, cfg.vocab, (1, 8),
                         generator=torch.Generator().manual_seed(1))
    logits, _ = t_tf.forward(p, toks, cfg)
    assert logits.is_inference() and logits.dtype == torch.bfloat16
    master = tree.tree_map(lambda t: t.float(), p)
    logits32, _ = t_tf.forward(master, toks, cfg)
    assert torch.equal(logits32, logits)    # the cast at use is the same


# --------------------------------------------------------------------------
# The train driver
# --------------------------------------------------------------------------

def run_driver(args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=420)


def test_train_crash_resume(tmp_path):
    base = ["--device", "cpu", "--arch", "minitron-8b", "--smoke",
            "--steps", "10", "--batch", "2", "--seq-len", "32"]
    args = base + ["--checkpoint-dir", str(tmp_path / "ckpt"),
                   "--checkpoint-every", "3", "--log-every", "1"]
    r1 = run_driver(args + ["--fail-at", "6"])
    assert r1.returncode == 17, (r1.stdout[-1000:], r1.stderr[-1000:])
    assert "fault injection" in r1.stdout
    r2 = run_driver(args)
    assert r2.returncode == 0, (r2.stdout[-1000:], r2.stderr[-1000:])
    assert "restored checkpoint at step 5" in r2.stdout
    assert "resuming from 6" in r2.stdout.replace("\n", " ")
    # the resumed losses are the uninterrupted run's (in-process, the
    # same step-indexed batches and restored state)
    whole = t_train.main(base + ["--log-every", "100"])
    resumed = [line.split()[3] for line in r2.stdout.splitlines()
               if line.startswith("step ")]
    assert resumed == [f"{x:.4f}" for x in whole["losses"][6:]]
    assert whole["steps_run"] == 10 and whole["start_step"] == 0


def test_driver_refusals():
    # a mesh that is not the world (one process without torchrun)
    with pytest.raises(SystemExit, match="mesh of 2 ranks; the world has 1"):
        t_train.main(["--device", "cpu", "--data", "2", "--steps", "1"])
    with pytest.raises(SystemExit, match="mesh of 2 ranks; the world has 1"):
        t_train.main(["--device", "cpu", "--model", "2", "--steps", "1"])
    with pytest.raises(SystemExit, match="LM archs"):
        t_train.main(["--device", "cpu", "--arch", "vit-b16", "--steps",
                      "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.main(["--arch", "minitron-8b", "--smoke", "--steps",
                          "1"])
    assert t_train.resolve_config("lm-100m", False).param_count() > 100e6
