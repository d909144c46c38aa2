"""Port parity: the Diffusion Transformer (DiT-L/2, DiT-XL/2) at SMOKE size.

Both packages get the same numpy inputs and parameters.  The reference
zero-initialises the adaLN modulation and the final projection, so its
DiT predicts 0 at init; every leaf is therefore drawn from a numpy seed at
O(1) scale around the init (the port's ``init_params``, in the reference's
tree and shapes), the zero leaves included.  The reference runs jitted with
``xla_allow_excess_precision`` off on a one-device host mesh, as
``tests/test_torch_vision.py`` runs it; the port on the CPU, where K7 and
K7b take their plain versions.  What each case holds, and why:

* ``patchify`` / ``unpatchify``: bit-equal to the reference's, and inverse;
* ``timestep_embedding`` within ``EMBED_TOL`` (float32 ``exp`` and
  ``sin``/``cos`` of arguments up to 999 differ by an ulp between the two
  libraries), ``alphas_cumprod`` within ``ACP_TOL`` (the reference's
  ``cumprod`` is an associative scan, the port's a running product);
* ``forward``'s eps and sigma at the config's latent size and at twice it
  (the position table resized) within ``OUT_TOL`` (max error over max
  |reference|): both compute in bf16, rounding at other places (measured
  4e-3 to 9e-3);
* one AdamW train step (weight decay 0): the loss within ``LOSS_TOL``, the
  gradient norm within ``GNORM_TOL``, each leaf's gradient (the first
  moment) within ``GRAD_TOL`` relative L2, every parameter within 2·lr;
* one DDIM sample step at t → t − 1 and at the last step (t_prev = −1,
  ᾱ = 1) within ``SAMPLE_TOL`` (measured 5e-5 and 9e-5: the update is
  float32 around the bf16 eps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import dit as j_dit
from repro.optim import optimizers as j_opt
from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.models import dit as t_dit
from repro_torch.optim import optimizers as t_opt

EMBED_TOL = 1e-4
ACP_TOL = 1e-5
OUT_TOL = 2e-2
LOSS_TOL = 5e-3
GNORM_TOL = 2e-2
GRAD_TOL = 5e-2
SAMPLE_TOL = 1e-3
ARCHS = ("dit-l2", "dit-xl2")


@pytest.fixture(scope="module")
def mesh_rules():
    mesh = make_host_mesh(data=1, model=1)
    return mesh, rules_for_mesh(mesh)


def exact_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


def rel_max(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def dit_case(arch, seed=0):
    """(reference config, port config, reference params, port params),
    every leaf drawn at O(1) scale around the init."""
    j_cfg, t_cfg = j_configs.get(arch).smoke, t_configs.get(arch).smoke
    init = t_dit.init_params(t_cfg, torch.Generator().manual_seed(seed),
                             "cpu")
    want = jax.eval_shape(lambda k: j_dit.init_params(k, j_cfg),
                          jax.random.key(0))
    assert jax.tree.structure(init) == jax.tree.structure(want)
    rng = np.random.default_rng(seed)

    def draw(a):
        a = a.numpy()
        s = 0.5 * float(a.std()) if a.std() > 0 else 0.2
        return (a + s * rng.standard_normal(a.shape)).astype(np.float32)
    npp = tree.tree_map(draw, init)
    assert [a.shape for a in tree.leaves(npp)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return (j_cfg, t_cfg, jax.tree.map(jnp.asarray, npp),
            t_dit.params_from_numpy(npp, t_cfg, "cpu"))


def test_patchify_unpatchify_exact():
    lat = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    want = np.asarray(j_dit.patchify(jnp.asarray(lat), 2))
    got = t_dit.patchify(torch.from_numpy(lat), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    back = t_dit.unpatchify(got, 2, 4, 4)
    np.testing.assert_array_equal(back.numpy(), lat)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_dit.unpatchify(jnp.asarray(want), 2, 4,
                                                  4)))


def test_timestep_embedding_and_schedule():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(j_dit.timestep_embedding(jnp.asarray(t)))
    got = t_dit.timestep_embedding(torch.from_numpy(t)).numpy()
    assert got.shape == (5, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    cfg = t_configs.get("dit-l2").full
    want = np.asarray(j_dit.alphas_cumprod(j_configs.get("dit-l2").full))
    got = t_dit.alphas_cumprod(cfg).numpy()
    assert got.shape == (1000,)
    np.testing.assert_allclose(got, want, rtol=ACP_TOL, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_dit_forward(arch, mesh_rules):
    """eps and sigma with non-zero adaLN and output weights, at the latent
    size (16 → 16 tokens a side / patch) and at twice it (the table
    resized)."""
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp = dit_case(arch)
    rng = np.random.default_rng(1)
    t = np.array([3, 700], np.int32)
    labels = np.array([1, j_cfg.n_classes], np.int32)   # the null class too
    for res in (j_cfg.latent_res(), 2 * j_cfg.latent_res()):
        lat = rng.standard_normal((2, res, res, 4)).astype(np.float32)
        with mesh:
            want = exact_jit(
                lambda p, a, b, c: j_dit.forward(p, a, b, c, j_cfg, rules),
                jp, lat, t, labels)(jp, lat, t, labels)
        got = t_dit.forward(tp, *(torch.from_numpy(a)
                                  for a in (lat, t, labels)), t_cfg)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and g.is_inference()
            assert float(np.abs(np.asarray(w, np.float32)).max()) > 0
            assert rel_max(g, w) <= OUT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_dit_train_step(arch, mesh_rules):
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp = dit_case(arch, seed=2)
    rng = np.random.default_rng(3)
    r = j_cfg.latent_res()
    batch = {"latents": rng.standard_normal((2, r, r, 4)).astype(np.float32),
             "labels": rng.integers(0, j_cfg.n_classes, (2,)).astype(
                 np.int32),
             "t": np.array([10, 900], np.int32),
             "noise": rng.standard_normal((2, r, r, 4)).astype(np.float32)}
    lr = 1e-4
    jb = jax.tree.map(jnp.asarray, batch)
    with mesh:
        js = j_opt.adamw_init(jp)
        step = exact_jit(j_dit.make_train_step(j_cfg, rules, lr=lr), jp, js,
                         jb)
        jp2, js2, jm = step(jp, js, jb)
    tp2, ts2, tm = t_dit.make_train_step(t_cfg, lr=lr)(
        tp, t_opt.adamw_init(tp), {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    want = float(jm["loss"])
    assert abs(tm["loss"].item() - want) <= LOSS_TOL * abs(want)
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
        GNORM_TOL * float(jm["grad_norm"])
    for (path, g), w in zip(tree.flatten_with_paths(ts2.mu),
                            jax.tree.leaves(js2.mu)):
        g, w = g.numpy(), np.asarray(w)
        assert np.linalg.norm(g - w) <= GRAD_TOL * np.linalg.norm(w), path
    for (path, a), b in zip(tree.flatten_with_paths(tp2),
                            jax.tree.leaves(jp2)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2 * lr * 1.001, \
            path


@pytest.mark.parametrize("arch", ARCHS)
def test_dit_sample_step(arch, mesh_rules):
    """One DDIM step in the chain and the last one (t_prev = -1)."""
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp = dit_case(arch, seed=4)
    r = j_cfg.latent_res()
    rng = np.random.default_rng(5)
    x_t = rng.standard_normal((2, r, r, 4)).astype(np.float32)
    labels = np.array([2, 5], np.int32)
    t_step = t_dit.make_sample_step(t_cfg)
    for t, t_prev in (([500, 20], [499, 19]), ([0, 0], [-1, -1])):
        t, t_prev = np.array(t, np.int32), np.array(t_prev, np.int32)
        with mesh:
            want = exact_jit(j_dit.make_sample_step(j_cfg, rules), jp, x_t,
                             t, t_prev, labels)(jp, x_t, t, t_prev, labels)
        got = t_step(tp, *(torch.from_numpy(a)
                           for a in (x_t, t, t_prev, labels)))
        assert got.dtype == torch.float32 and got.shape == x_t.shape
        assert rel_max(got, want) <= SAMPLE_TOL
