"""Port parity: the training substrate — STE sign, optimizers, data
pipelines and checkpoints (``repro_torch.core.binarize``, ``optim``,
``data``, ``checkpoint``, ``tree``).

Both packages get the same numpy inputs.  What each case holds:

* ``ste_sign``, ``clip_latent``, ``binarize01``: forward and gradient
  exactly (they are selections and masks);
* ``cosine_schedule`` at every step of a short schedule within 1e-6
  relative: float32 ``cos`` in XLA and PyTorch may differ in the last ulp;
* ``TokenPipeline``, ``ImagePipeline``, ``LatentPipeline``: ``batch_at``
  bit for bit for several (seed, step) pairs, and ``iter_from(k)`` equal
  to ``batch_at(k), batch_at(k + 1), ...``;
* the leaf paths the optimizers' ``clip_latent_paths`` sees and the
  checkpoints' keys: equal to ``jax.tree_util.keystr`` of the reference's
  flattening, in its order;
* ``adamw_update`` / ``sgdm_update`` over one and three steps on a tree of
  float32 and bf16 leaves, with global-norm clipping, weight decay, a
  schedule and ``clip_latent_paths``: float32 parameters and moments
  within 1e-6 (the same float32 operations in the same order; ``pow`` and
  ``sqrt`` may differ in the last ulp), bf16 parameters equal, or one
  bf16 step apart where a last-ulp float32 difference crosses a rounding
  boundary (``BF16_STEP``);
* checkpoints across packages: the reference's ``save`` restored by the
  port and the port's restored by the reference's ``restore``, exactly;
  a ``tmp.*`` leftover ignored, retention, the async writer, a shape
  mismatch raising ``ValueError``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.core import binarize as j_bin
from repro.data import pipeline as j_pipe
from repro.optim import optimizers as j_opt
from repro_torch import tree
from repro_torch.checkpoint import store as t_store
from repro_torch.core import binarize as t_bin
from repro_torch.data import pipeline as t_pipe
from repro_torch.optim import optimizers as t_opt

F32_TOL = 1e-6
BF16_STEP = 2.0 ** -7          # one bf16 step relative to a value's scale


def to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------------
# STE sign
# --------------------------------------------------------------------------

def test_ste_sign_forward_and_gradient():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array([0.0, 1.0, -1.0, 1.5, -1.5, 1e-7, -1e-7,
                                  0.999, -0.999, 1.0001, -1.0001],
                                 np.float32),
                        rng.uniform(-3, 3, 200).astype(np.float32)])
    g = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(j_bin.ste_sign, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    got = t_bin.ste_sign(tx)
    (got_g,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert got[0].item() == 1.0                       # sign(0) = +1


def test_clip_latent_and_binarize01():
    x = np.random.default_rng(1).uniform(-3, 3, (7, 9)).astype(np.float32)
    x[0, :3] = [0.0, 1.0, -1.0]
    np.testing.assert_array_equal(t_bin.clip_latent(torch.from_numpy(x))
                                  .numpy(),
                                  np.asarray(j_bin.clip_latent(x)))
    got = t_bin.binarize01(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_bin.binarize01(x)))


# --------------------------------------------------------------------------
# Schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base,warmup,total", [(3e-4, 5, 20), (1e-3, 0, 7),
                                               (1e-3, 20, 10)])
def test_cosine_schedule_every_step(base, warmup, total):
    t_lr = t_opt.cosine_schedule(base, warmup, total)
    j_lr = j_opt.cosine_schedule(base, warmup, total)
    for step in range(total + 3):
        got = t_lr(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(j_lr(step)),
                                   rtol=F32_TOL, atol=0)
        np.testing.assert_allclose(
            t_lr(torch.tensor(step, dtype=torch.int32)).item(),
            float(j_lr(jnp.int32(step))), rtol=F32_TOL, atol=0)


# --------------------------------------------------------------------------
# Data pipelines
# --------------------------------------------------------------------------

PIPES = [
    (t_pipe.TokenPipeline, j_pipe.TokenPipeline,
     dict(batch=3, seq_len=17, vocab=300)),
    (t_pipe.ImagePipeline, j_pipe.ImagePipeline,
     dict(batch=2, img_res=9, n_classes=7)),
    (t_pipe.LatentPipeline, j_pipe.LatentPipeline,
     dict(batch=2, latent_res=5, channels=3, n_classes=5, n_timesteps=50)),
]


@pytest.mark.parametrize("t_cls,j_cls,kw", PIPES,
                         ids=["tokens", "images", "latents"])
def test_batch_at_bit_for_bit(t_cls, j_cls, kw):
    for seed, step in [(0, 0), (0, 1), (3, 0), (3, 17), (12345, 999)]:
        got = t_cls(seed=seed, **kw).batch_at(step)
        want = j_cls(seed=seed, **kw).batch_at(step)
        assert sorted(got) == sorted(want)
        for key in want:
            w = np.asarray(want[key])
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("t_cls,j_cls,kw", PIPES,
                         ids=["tokens", "images", "latents"])
def test_iter_from_resumes(t_cls, j_cls, kw, prefetch):
    pipe = t_cls(seed=4, prefetch=prefetch, **kw)
    it = pipe.iter_from(5)
    for step in range(5, 9):
        got = next(it)
        want = pipe.batch_at(step)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    it.close()


def test_pipeline_places_on_device():
    got = t_pipe.TokenPipeline(seed=2, batch=2, seq_len=8, vocab=50,
                               device="cpu").batch_at(3)
    want = j_pipe.TokenPipeline(seed=2, batch=2, seq_len=8,
                                vocab=50).batch_at(3)
    for key in want:
        assert torch.is_tensor(got[key]) and got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), want[key])


# --------------------------------------------------------------------------
# Tree paths
# --------------------------------------------------------------------------

def bnn_like(rng):
    return [dict(w=rng.standard_normal((3, 4)), gamma=rng.standard_normal(4)),
            {}, dict(w=rng.standard_normal((4, 2)), b=rng.standard_normal(2))]


def lm_like(rng):
    return {"embed": rng.standard_normal((5, 4)),
            "layers": {"wq": rng.standard_normal((2, 4, 4)),
                       "ln1": rng.standard_normal((2, 4)),
                       "w_up": rng.standard_normal((2, 4, 8))},
            "final_norm": rng.standard_normal(4)}


def j_paths(t):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(t)[0]]


@pytest.mark.parametrize("make", [bnn_like, lm_like])
def test_paths_are_the_references(make):
    rng = np.random.default_rng(0)
    t = make(rng)
    t_tree = tree.tree_map(lambda a: torch.from_numpy(np.asarray(a)), t)
    got = [p for p, _ in tree.flatten_with_paths(t_tree)]
    assert got == j_paths(jax.tree.map(jnp.asarray, t))
    # through the optimizer state, as a checkpoint of {params, opt} keys it
    t_state = {"params": t_tree, "opt": t_opt.adamw_init(t_tree)}
    j_params = jax.tree.map(jnp.asarray, t)
    j_state = {"params": j_params, "opt": j_opt.adamw_init(j_params)}
    got = [p for p, _ in tree.flatten_with_paths(t_state)]
    assert got == j_paths(j_state)
    assert "['opt'].step" in got
    assert any(path.startswith("['opt'].mu[") for path in got)


def test_unflatten_round_trip():
    t = {"b": [torch.ones(2), None, (torch.zeros(1), torch.ones(3))],
         "a": t_opt.OptState(torch.tensor(1), {"x": torch.ones(2)}, None)}
    back = tree.unflatten(t, tree.leaves(t))
    assert list(back) == ["b", "a"]
    assert back["b"][1] is None and isinstance(back["b"][2], tuple)
    assert isinstance(back["a"], t_opt.OptState) and back["a"].nu is None
    with pytest.raises(ValueError):
        tree.unflatten(t, tree.leaves(t) + [torch.ones(1)])


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

def opt_tree(rng):
    """Numpy params with float32 and bf16 leaves (bf16 values exact in
    float32), and latent weights under 'w'."""
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    params = {"w": rng.uniform(-1.2, 1.2, (6, 5)).astype(np.float32),
              "head": {"kernel": rng.standard_normal((5, 3))
                       .astype(np.float32),
                       "scale": bf(rng.standard_normal(7))},
              "layers": [rng.standard_normal(4).astype(np.float32),
                         bf(rng.standard_normal((3, 2)))]}
    dtypes = {"w": "f32", "head": {"kernel": "f32", "scale": "bf16"},
              "layers": ["f32", "bf16"]}
    return params, dtypes


def to_jax(params, dtypes):
    return jax.tree.map(lambda a, d: jnp.asarray(
        a, jnp.bfloat16 if d == "bf16" else jnp.float32), params, dtypes)


def to_torch(params, dtypes):
    return jax.tree.map(lambda a, d: torch.from_numpy(np.array(a)).to(
        torch.bfloat16 if d == "bf16" else torch.float32), params, dtypes)


def assert_params_match(got, want, dtypes):
    for (path, g), w, d in zip(tree.flatten_with_paths(got),
                               jax.tree.leaves(want), jax.tree.leaves(dtypes)):
        g, w = to_np(g), to_np(w)
        if d == "f32":
            np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=BF16_STEP * np.abs(w).max(), err_msg=path)
            assert (g != w).mean() <= 0.1, path


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", ["clip_norm", "no_clip", "schedule"])
def test_adamw_matches_reference(steps, case):
    rng = np.random.default_rng(steps)
    params, dtypes = opt_tree(rng)
    jp, tp = to_jax(params, dtypes), to_torch(params, dtypes)
    js, ts = j_opt.adamw_init(jp), t_opt.adamw_init(tp)
    kw = dict(weight_decay=0.1, clip_latent_paths=lambda p: "w" in p)
    if case == "no_clip":
        kw["max_grad_norm"] = 1e6
    lr = (3e-2 if case != "schedule" else None)
    j_lr = lr if lr else j_opt.cosine_schedule(3e-2, 2, 5)
    t_lr = lr if lr else t_opt.cosine_schedule(3e-2, 2, 5)
    for i in range(steps):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32)
            * (3.0 if case == "clip_norm" else 0.1), params)
        jp, js, jm = j_opt.adamw_update(jp, to_jax(grads, dtypes), js,
                                        lr=j_lr, **kw)
        tp, ts, tm = t_opt.adamw_update(tp, to_torch(grads, dtypes), ts,
                                        lr=t_lr, **kw)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=F32_TOL)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=F32_TOL)
    assert int(ts.step) == int(js.step) == steps
    assert_params_match(tp, jp, dtypes)
    for got, want in ((ts.mu, js.mu), (ts.nu, js.nu)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(to_np(g), to_np(w), rtol=1e-5,
                                       atol=F32_TOL)
    # the latent weights stay in [-1, 1]; the others are not clipped
    assert float(tp["w"].abs().max()) <= 1.0
    for leaf, d in zip(tree.leaves(tp), jax.tree.leaves(dtypes)):
        assert leaf.dtype == (torch.bfloat16 if d == "bf16"
                              else torch.float32)


@pytest.mark.parametrize("max_grad_norm", [0.0, 0.5])
def test_sgdm_matches_reference(max_grad_norm):
    rng = np.random.default_rng(7)
    params, dtypes = opt_tree(rng)
    jp, tp = to_jax(params, dtypes), to_torch(params, dtypes)
    js, ts = j_opt.sgdm_init(jp), t_opt.sgdm_init(tp)
    assert ts.nu is None
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            params)
        jp, js, jm = j_opt.sgdm_update(jp, to_jax(grads, dtypes), js,
                                       lr=0.05, max_grad_norm=max_grad_norm)
        tp, ts, tm = t_opt.sgdm_update(tp, to_torch(grads, dtypes), ts,
                                       lr=0.05, max_grad_norm=max_grad_norm)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=F32_TOL)
    assert_params_match(tp, jp, dtypes)


def test_global_norm_and_clip():
    rng = np.random.default_rng(3)
    params, dtypes = opt_tree(rng)
    jg, tg = to_jax(params, dtypes), to_torch(params, dtypes)
    np.testing.assert_allclose(t_opt.global_norm(tg).item(),
                               float(j_opt.global_norm(jg)), rtol=F32_TOL)
    got, gn = t_opt.clip_by_global_norm(tg, 0.5)
    want, wn = j_opt.clip_by_global_norm(jg, 0.5)
    np.testing.assert_allclose(gn.item(), float(wn), rtol=F32_TOL)
    assert_params_match(got, want, dtypes)
    np.testing.assert_allclose(t_opt.global_norm(got).item(), 0.5, rtol=1e-2)


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------

def state_trees(rng):
    params = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
              "layers": {"wq": rng.standard_normal((2, 4, 4))
                         .astype(np.float32),
                         "ln1": rng.standard_normal((2, 4))
                         .astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    j_state = {"params": jp, "opt": j_opt.adamw_init(jp)._replace(
        step=jnp.int32(5),
        mu=jax.tree.map(lambda a: a * 0.5, jp),
        nu=jax.tree.map(lambda a: a * a, jp))}
    t_state = tree.tree_map(lambda a: torch.from_numpy(np.array(a)),
                            {"params": params,
                             "opt": t_opt.OptState(
                                 np.array(5, np.int32),
                                 jax.tree.map(lambda a: a * 0.5, params),
                                 jax.tree.map(lambda a: a * a, params))})
    return j_state, t_state


def zeros_like_port(t_state):
    return tree.tree_map(torch.zeros_like, t_state)


def assert_trees_equal(got, want):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(to_np(g), to_np(w))


def test_reference_checkpoint_restores_in_port(tmp_path):
    j_state, t_state = state_trees(np.random.default_rng(0))
    j_store.save(tmp_path, 5, j_state)
    assert t_store.latest_step(tmp_path) == 5
    got = t_store.restore(tmp_path, 5, zeros_like_port(t_state))
    assert_trees_equal(got, j_state)
    assert isinstance(got["opt"], t_opt.OptState)
    assert got["opt"].step.dtype == torch.int32


def test_port_checkpoint_restores_in_reference(tmp_path):
    j_state, t_state = state_trees(np.random.default_rng(1))
    t_store.save(tmp_path, 8, t_state)
    assert j_store.latest_step(tmp_path) == 8
    like = jax.tree.map(jnp.zeros_like, j_state)
    got = j_store.restore(tmp_path, 8, like)
    assert_trees_equal(t_state, got)


def test_tmp_leftover_ignored_and_shape_mismatch(tmp_path):
    _, t_state = state_trees(np.random.default_rng(2))
    t_store.save(tmp_path, 3, t_state)
    (tmp_path / "tmp.9.12345.npz").write_bytes(b"partial write")
    assert t_store.latest_step(tmp_path) == 3
    mgr = t_store.CheckpointManager(str(tmp_path))
    step, got = mgr.restore_latest(zeros_like_port(t_state))
    assert step == 3
    assert_trees_equal(got, tree.tree_map(lambda t: t.numpy(), t_state))
    bad = zeros_like_port(t_state)
    bad["params"]["embed"] = torch.zeros(7, 4)
    with pytest.raises(ValueError, match="shape"):
        t_store.restore(tmp_path, 3, bad)
    assert t_store.latest_step(tmp_path / "absent") is None
    assert t_store.CheckpointManager(str(tmp_path / "absent")) \
        .restore_latest(bad) == (None, None)


def test_retention_and_async_writer(tmp_path):
    _, t_state = state_trees(np.random.default_rng(3))
    mgr = t_store.CheckpointManager(str(tmp_path), keep=2)
    for step in range(4):
        mgr.save(step, t_state)
    assert sorted(os.listdir(tmp_path)) == ["step_2.npz", "step_3.npz"]
    live = tree.tree_map(lambda t: t + 1, t_state)
    mgr.save_async(4, live)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_3.npz", "step_4.npz"]
    got = t_store.restore(tmp_path, 4, zeros_like_port(t_state))
    assert_trees_equal(got, tree.tree_map(lambda t: t.numpy(), live))


def test_async_writer_surfaces_errors(tmp_path):
    _, t_state = state_trees(np.random.default_rng(4))
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = t_store.CheckpointManager(str(blocker / "ckpt"))
    mgr.save_async(1, t_state)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                # the error is raised once


def test_bf16_leaf_round_trip(tmp_path):
    t = {"w": torch.randn(5, 3).to(torch.bfloat16), "s": torch.tensor(2)}
    t_store.save(tmp_path, 0, t)
    got = t_store.restore(tmp_path, 0, tree.tree_map(torch.zeros_like, t))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], t["w"]) and int(got["s"]) == 2
