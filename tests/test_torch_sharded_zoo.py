"""Port parity on a mesh: the vision and diffusion zoo under ``rules``.

ViT, DiT, ConvNeXt and EfficientNet (SMOKE configs) sharded over gloo
ranks against the reference's one-device program and the port's
one-device path.  One module-scoped spawn of 4 ranks (one thread a rank,
a join timeout ``JOIN_S``, ``file://`` rendezvous) runs every rank-side
case on a (2, 2) mesh, then on a (1, 4) mesh over the same ranks; this
process computes the JAX side while they run (the spawn waits on a
thread), and the one-device port path, and hands the ranks numpy arrays
(the ranks import no JAX).  Parameters are the port's
init drawn from a numpy seed at O(1) scale around it (``randomize``, as
``tests/test_torch_vision.py`` draws them: the reference zero-initialises
biases and DiT's modulations, so a check at init values would prove
little).  Compared:

* specs: each arch's ``param_specs`` equal to the reference's as tuples on
  stand-in (2, 2), (1, 4) and (4, 1) meshes (a conv kernel's spec in the
  port's (O, I, KH, KW) layout: ``zoo_mesh.conv_spec`` of the
  reference's HWIO one; EfficientNet's state specs too);
* the new differentiable collectives are their forwards' transposes:
  ⟨f(x), y⟩ = ⟨x, fᵀ(y)⟩ summed over the ranks, a value replicated over
  ``copies`` ranks counted once (float64, to ``ADJOINT_TOL`` relative):
  ``reduce_scatter_model`` and ``row_parallel(..., scatter_axis=)`` over
  ``model``, ``sum_stats`` over ``data``, ``gather_model_leaves`` over
  ``model``;
* per arch on (2, 2) and (1, 4): the loss (the train step's: the rank's
  rows of a batch of 4, DiT's whole batch) and each gathered gradient
  leaf against ``jax.value_and_grad`` of the reference's loss on a (1, 1)
  mesh, jitted with ``xla_allow_excess_precision`` off (the loss within
  ``LOSS_TOL``, each leaf within ``GRAD_TOL`` relative L2 of its own norm
  or of ``GRAD_FLOOR`` of the tree's, ``tests/test_torch_vision.py``'s
  rule for leaves whose gradient is ~0, as a bias under a batch norm);
  against the port's one-device path (``SINGLE_LOSS_TOL``,
  ``SINGLE_GRAD_TOL``: a column-parallel product's bf16 outputs are the
  one-device ones up to the accumulation order, a row-parallel sum
  rounds its float32 partials once); with float32 compute
  (``layers.COMPUTE_DTYPE``) against one device to ``F32_TOL`` (the same
  floor: a BN bias whose gradient is 0 in exact arithmetic reads O(1)
  relative noise), where a misplaced collective moves a leaf by O(1).
  Measured (CPU): against the reference loss 1.8e-5 to 1.5e-4, leaves
  8.2e-3 to 1.6e-2 (EfficientNet, float32: 1.0e-7, 8.5e-6); against one
  device in bf16 the loss 0 to 6.8e-8, leaves 3.2e-3 to 7.3e-3, the
  output bit for bit; float32 leaves 3.5e-7 to 5.7e-6.  The serving forward, whole
  on every rank, within ``SINGLE_OUT_TOL`` of one device's (float32:
  ``F32_TOL``).  EfficientNet's train-mode batch norm is ill-conditioned
  at SMOKE size (ROADMAP caveat (i): the reference's logits move 127%
  when one bit of 1% of the input pixels flips), so it keeps caveat (i)'s
  size (2 × 128², float) and meets the reference in float32 compute on
  both sides (the reference's ``layers.COMPUTE_DTYPE`` patched in this
  process; no JAX file changes), its bf16 run against the one-device port
  path with the loss within ``LOSS_TOL`` and each leaf within
  ``EFF_SINGLE_TOL`` (measured 1.9e-3 and 7.8e-2 on (2, 2), where the
  batch statistics are summed over ``data`` in another order, and bit
  for bit on (1, 4));
* DiT: the FULL configs' ``seq_shard`` (the residual cut by tokens over
  ``model``, a reduce-scatter a block boundary) on and off; a batch of 1,
  which does not divide ``data`` (its tokens over ``data``); ``"dots"``
  against ``"nothing"`` bit for bit; one DDIM sample step whole on every
  rank;
* EfficientNet's synced batch norm: the running statistics of the
  float32 step 0 equal on every data rank (bit for bit) and, gathered
  over ``model``, within ``F32_TOL`` of the one-device ones;
* ViT ``binary_dense``: one AdamW step at lr 1 on (2, 2), every
  binarised latent within [-1, 1] and the updated params within 2·lr of
  the one-device step's (AdamW's first step moves each element by
  ±lr).
"""

import concurrent.futures
import contextlib
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.distributed import rules_for_mesh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import gather
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convnext as t_cn
from repro_torch.models import dit as t_dit
from repro_torch.models import efficientnet as t_eff
from repro_torch.models import layers as t_layers
from repro_torch.models import vit as t_vit
from repro_torch.models import zoo_mesh
from repro_torch.optim import optimizers as t_opt

JOIN_S = 300
LOSS_TOL = 5e-3          # tests/test_torch_train.py's
GRAD_TOL = 5e-2
GRAD_FLOOR = 0.05        # tests/test_torch_vision.py's
SINGLE_LOSS_TOL = 1e-5
SINGLE_GRAD_TOL = 2e-2
SINGLE_OUT_TOL = 2e-2
EFF_SINGLE_TOL = 0.1
F32_TOL = 1e-5
ADJOINT_TOL = 1e-12
BATCH = 4
MESHES = ((2, 2), (1, 4))
ARCHS = ("vit-h14", "dit-xl2", "convnext-b", "efficientnet-b7")
MODS = {"vit-h14": t_vit, "dit-xl2": t_dit, "convnext-b": t_cn,
        "efficientnet-b7": t_eff}
# EfficientNet's train-mode input: caveat (i)'s conditioned size, 2 ×
# 128² (one image a data rank on (2, 2))
RES = {"efficientnet-b7": 128}
BATCHES = {"efficientnet-b7": 2}
BINARY_LR = 1.0


def smoke(arch, **kw):
    cfg = t_configs.get(arch).smoke
    if arch == "dit-xl2":      # the FULL configs' Megatron-SP residual
        cfg = dataclasses.replace(cfg, seq_shard=True)
    return dataclasses.replace(cfg, **kw)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def rel_max(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def float32_compute():
    return mock.patch.object(t_layers, "COMPUTE_DTYPE", torch.float32)


def maybe32(f32: bool):
    return float32_compute() if f32 else contextlib.nullcontext()


def map_named(fn, t, name=""):
    if isinstance(t, dict):
        return {k: map_named(fn, v, k) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(map_named(fn, v, name) for v in t)
    return fn(name, t)


def numpy_params(arch, seed: int):
    """The port's init for the SMOKE config, every leaf drawn anew at O(1)
    scale around it (plus N(0, (s/2)²) for a leaf of spread s, N(0, 0.2²)
    for a constant one; BN variances exp(N(0, 0.3²))), in the reference's
    layouts (conv kernels HWIO), float32."""
    mod, cfg = MODS[arch], smoke(arch)
    rng = np.random.default_rng(seed)
    full = mod.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")

    def leaf(name, t):
        if name in getattr(mod, "CONV_LEAVES", ()):
            t = t_layers.oihw_to_hwio(t)
        a = t.float().numpy()
        if name == "var":
            return np.exp(0.3 * rng.standard_normal(a.shape)).astype(
                np.float32)
        sd = float(a.std()) if a.size > 1 else 0.0
        s = 0.5 * sd if sd > 0 else 0.2
        return (a + s * rng.standard_normal(a.shape)).astype(np.float32)

    return map_named(leaf, full)


def make_batch(arch, seed: int, n: int | None = None):
    cfg = smoke(arch)
    n = n or BATCHES.get(arch, BATCH)
    rng = np.random.default_rng(seed)
    if arch == "dit-xl2":
        hl = cfg.latent_res()
        return {"latents": rng.standard_normal((n, hl, hl, 4)).astype(
                    np.float32),
                "noise": rng.standard_normal((n, hl, hl, 4)).astype(
                    np.float32),
                "t": rng.integers(0, 1000, n).astype(np.int32),
                "labels": rng.integers(0, cfg.n_classes, n).astype(
                    np.int32)}
    r = RES.get(arch, cfg.img_res)
    return {"images": rng.random((n, r, r, 3), dtype=np.float32),
            "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32)}


def t_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# Both sides' loss, gradients and serving output (the port's)
# --------------------------------------------------------------------------

def port_params(arch, params_np, rules=None):
    mod, cfg = MODS[arch], smoke(arch)
    got = mod.params_from_numpy(params_np, cfg, "cpu", rules=rules)
    return got if arch == "efficientnet-b7" else (got, None)


def specs_of(arch, cfg, rules):
    specs = MODS[arch].param_specs(cfg, rules)
    return specs[0] if arch == "efficientnet-b7" else specs


def rank_rows(batch, rules):
    """The rank's rows of a numpy batch, cut over every batch axis."""
    if rules is None:
        return t_batch(batch)
    n = len(batch["labels"]) // rules.dp
    lo = rules.coordinate(rules.batch) * n
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + n]))
            for k, v in batch.items()}


def loss_grads(arch, params_np, batch, f32: bool, rules=None, **kw):
    """(loss, gradient leaves whole, serving output whole, new BN state)
    of the port on ``rules`` (None: one device)."""
    cfg = smoke(arch, **kw)
    mod = MODS[arch]
    with maybe32(f32):
        params, state = port_params(arch, params_np, rules)
        if arch == "dit-xl2":
            b = t_batch(batch)
            (loss, _), grads = tree.value_and_grad(mod.train_loss, params,
                                                   b, cfg, rules)
            out = mod.forward(params, b["latents"], b["t"], b["labels"],
                              cfg, rules)[0]
        elif arch == "efficientnet-b7":
            (loss, new_state), grads = tree.value_and_grad(
                mod.loss_fn, params, state, rank_rows(batch, rules), cfg,
                rules)
            out = mod.apply(params, state, t_batch(batch)["images"], cfg,
                            train=False, rules=rules)[0]
        else:
            (loss, _), grads = tree.value_and_grad(
                mod.loss_fn, params, rank_rows(batch, rules), cfg, rules)
            out = mod.forward(params, t_batch(batch)["images"], cfg, rules)
        if rules is not None:
            specs = specs_of(arch, cfg, rules)
            grads = sharding.sync_grads(grads, specs, rules)
            leaves = [gather(g, s, rules).numpy() for g, s in
                      zip(tree.leaves(grads), tree.leaves(specs))]
        else:
            leaves = [g.numpy() for g in tree.leaves(grads)]
    state_out = None
    if arch == "efficientnet-b7":     # (the rank's blocks, whole)
        mine = [t.detach() for t in tree.leaves(new_state)]
        whole = mine if rules is None else [
            gather(t, s, rules, axes=("model",)) for t, s in zip(
                mine, tree.leaves(MODS[arch].param_specs(cfg, rules)[1]))]
        state_out = ([t.numpy() for t in mine], [t.numpy() for t in whole])
    return (float(loss), leaves, out.float().numpy(), state_out)


# --------------------------------------------------------------------------
# The ranks (no JAX)
# --------------------------------------------------------------------------

def adjoint_cases(rules, rank):
    """(name, ⟨f(x), y⟩, ⟨x, fᵀ(y)⟩) of each new differentiable collective
    on this rank, each divided by the copies of a replicated value."""
    model, data = rules.comm("model"), rules.comm("data")
    tp = model.size
    row = rules.coordinate("data")        # shared by a model group

    def draw(shape, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g, dtype=torch.float64)

    def rs_product(x):
        w = draw((4, 3), 150 + rank)      # the rank's rows of w
        return t_layers.row_parallel(x, w, model, scatter_axis=1)

    ops = [  # name, f, x, y, copies of x, copies of f(x)
        ("reduce_scatter_model",
         lambda x: sharding.reduce_scatter_model(x, model, 1),
         draw((2, 2 * tp, 3), 10 + rank), draw((2, 2, 3), 20 + rank), 1, 1),
        ("row_parallel scatter", rs_product,
         draw((2, 2 * tp, 4), 30 + rank), draw((2, 2, 3), 40 + rank), 1, 1),
        ("sum_stats", lambda x: sharding.sum_stats(x, data),
         draw((5,), 50 + rank), draw((5,), 60 + rank), 1, 1),
        ("gather_model_leaves", lambda x: sharding.gather_model_leaves(
            [x], [1], model)[0],
         draw((3, 4), 70 + rank), draw((3, 4 * tp), 80 + row), 1, tp),
    ]
    out = []
    with mock.patch.object(t_layers, "COMPUTE_DTYPE", torch.float64):
        for name, f, x, y, cx, cy in ops:
            x = x.requires_grad_()
            fx = f(x)
            (g,) = torch.autograd.grad(fx, x, y)
            out.append((name, float((fx.detach() * y).sum()) / cy,
                        float((x.detach() * g).sum()) / cx))
    return out


def dit_extras(rules, inp):
    """DiT on (2, 2): seq_shard off (float32), a batch of 1 (tokens over
    ``data``; bf16 and float32), "dots" against "nothing" (bf16, seq_shard
    on), one sample step."""
    p = inp["params", "dit-xl2"]
    out = {"seq_off": loss_grads("dit-xl2", p, inp["batch", "dit-xl2"],
                                 True, rules, seq_shard=False)}
    out["one"] = [loss_grads("dit-xl2", p, inp["dit_one"], f32, rules)
                  for f32 in (False, True)]
    remat = {}
    for policy in ("nothing", "dots"):
        before = sharding.Collective.calls
        loss, leaves, _, _ = loss_grads("dit-xl2", p,
                                        inp["batch", "dit-xl2"], False,
                                        rules, remat_policy=policy)
        remat[policy] = (loss, leaves, sharding.Collective.calls - before)
    out["remat"] = remat
    cfg = smoke("dit-xl2")
    params, _ = port_params("dit-xl2", p, rules)
    b = t_batch(inp["batch", "dit-xl2"])
    step = t_dit.make_sample_step(cfg, rules)
    out["sample"] = step(params, b["latents"], b["t"].long(),
                         b["t"].long() - 20, b["labels"]).float().numpy()
    return out


def vit_binary_step(rules, inp):
    cfg = smoke("vit-h14", binary_dense=True)
    params = t_vit.params_from_numpy(inp["params", "vit-h14"], cfg, "cpu",
                                     rules=rules)
    step = t_vit.make_train_step(cfg, rules, lr=BINARY_LR)
    params, _, m = step(params, t_opt.adamw_init(params),
                        rank_rows(inp["batch", "vit-h14"], rules))
    specs = t_vit.param_specs(cfg, rules)
    return float(m["loss"]), [gather(p, s, rules).numpy() for p, s in zip(
        tree.leaves(params), tree.leaves(specs))]


def rank_main(rank, device, inp):
    out = {}
    for shape in MESHES:
        rules = rules_for_mesh(mesh_lib.make_host_mesh(
            data=shape[0], model=shape[1], device=device))
        if shape == (2, 2):
            out["adjoint"] = adjoint_cases(rules, rank)
            out["dit"] = dit_extras(rules, inp)
            out["binary"] = vit_binary_step(rules, inp)
        for arch in ARCHS:
            out["case", arch, shape] = [
                loss_grads(arch, inp["params", arch], inp["batch", arch],
                           f32, rules) for f32 in (False, True)]
    if rank:           # leaves and outputs of rank 0 alone go back
        for key, val in out.items():
            if key[0] == "case":
                out[key] = [(v[0], None, None, v[3]) for v in val]
        out["dit"] = {"remat": {k: (v[0], None, v[2]) for k, v in
                                out["dit"]["remat"].items()}}
        out["binary"] = (out["binary"][0], None)
    return out


@pytest.fixture(scope="module")
def inputs():
    inp = {}
    for i, arch in enumerate(ARCHS):
        inp["params", arch] = numpy_params(arch, 30 + i)
        inp["batch", arch] = make_batch(arch, 40 + i)
    inp["dit_one"] = make_batch("dit-xl2", 50, n=1)
    return inp


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """The ranks' spawn, started on a thread of this process so that the
    JAX side compiles while they run."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(mesh_lib.spawn, rank_main, 4, inputs, device="cpu",
                      threads=1, timeout_s=JOIN_S,
                      workdir=str(tmp_path_factory.mktemp("zoo-mesh")))
    pool.shutdown()


@pytest.fixture(scope="module")
def ranks(spawned, jax_side):
    del jax_side               # computed while the ranks run
    return spawned.result()


@contextlib.contextmanager
def one_thread():
    """torch on one thread (the gloo ranks have one each): beside other
    test workers a pool of threads a core spins on each small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single(inputs):
    """The port's one-device path, bf16 and float32."""
    with one_thread():
        return one_device(inputs)


def one_device(inputs):
    out = {}
    for arch in ARCHS:
        out[arch] = [loss_grads(arch, inputs["params", arch],
                                inputs["batch", arch], f32)
                     for f32 in (False, True)]
    p = inputs["params", "dit-xl2"]
    out["dit_one"] = [loss_grads("dit-xl2", p, inputs["dit_one"], f32)
                      for f32 in (False, True)]
    cfg = smoke("dit-xl2")
    params, _ = port_params("dit-xl2", p)
    b = t_batch(inputs["batch", "dit-xl2"])
    out["sample"] = t_dit.make_sample_step(cfg)(
        params, b["latents"], b["t"].long(), b["t"].long() - 20,
        b["labels"]).float().numpy()
    cfg = smoke("vit-h14", binary_dense=True)
    params = t_vit.params_from_numpy(inputs["params", "vit-h14"], cfg, "cpu")
    params, _, _ = t_vit.make_train_step(cfg, lr=BINARY_LR)(
        params, t_opt.adamw_init(params), t_batch(inputs["batch", "vit-h14"]))
    out["binary"] = [p.numpy() for p in tree.leaves(params)]
    return out


def exact_jit(fn, *args):
    """``fn`` compiled with every bf16 intermediate rounded, as eager ops
    round them (``tests/test_torch_train.py``'s)."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def jax_side(inputs, spawned):
    """The reference on a (1, 1) mesh: each arch's train loss and its
    gradient leaves (EfficientNet's in float32 compute)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.distributed.sharding import rules_for_mesh as j_rules
    from repro.launch.mesh import make_host_mesh as j_mesh
    from repro.models import convnext as j_cn
    from repro.models import dit as j_dit
    from repro.models import efficientnet as j_eff
    from repro.models import layers as j_layers
    from repro.models import vit as j_vit

    mesh = j_mesh(data=1, model=1)
    rules = j_rules(mesh)
    del spawned                # the ranks run meanwhile
    out = {}
    with mesh:
        for arch in ARCHS:
            cfg = j_configs.get(arch).smoke
            jp = jax.tree.map(jnp.asarray, inputs["params", arch])
            jb = jax.tree.map(jnp.asarray, inputs["batch", arch])
            f32 = arch == "efficientnet-b7"
            if arch == "vit-h14":
                fn = lambda p, b: j_vit.loss_fn(p, b, cfg, rules)[0]  # noqa
            elif arch == "dit-xl2":
                cfg = dataclasses.replace(cfg, seq_shard=True)
                fn = lambda p, b: j_dit.train_loss(p, b, cfg, rules)[0]  # noqa
            elif arch == "convnext-b":
                fn = lambda p, b: j_cn.loss_fn(p, b, cfg, rules)[0]  # noqa
            else:
                fn = lambda p, b: j_eff.loss_fn(  # noqa
                    p[0], p[1], b, cfg, rules)[0]
            with (mock.patch.object(j_layers, "COMPUTE_DTYPE", jnp.float32)
                  if f32 else contextlib.nullcontext()):
                vg = jax.value_and_grad(fn)
                loss, grads = exact_jit(vg, jp, jb)(jp, jb)
            if arch == "efficientnet-b7":
                grads = grads[0]
            out[arch] = (float(loss), [np.asarray(g, np.float32)
                                       for g in jax.tree.leaves(grads)])
    return out


def conv_to_hwio(arch, leaves, paths):
    """The port's gradient leaves in the reference's layouts."""
    conv = getattr(MODS[arch], "CONV_LEAVES", ())
    return [t_layers.oihw_to_hwio(torch.from_numpy(a)).numpy()
            if any(f"['{c}']" in p for c in conv) else a
            for a, p in zip(leaves, paths)]


def leaf_paths(arch):
    params = MODS[arch].abstract_params(smoke(arch))
    if arch == "efficientnet-b7":
        params = params[0]
    return [p for p, _ in tree.flatten_with_paths(params)]


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------

def stand_in(shape):
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))


def map_specs(fn, t, name=""):
    """``fn(name, spec)`` at each spec of a tree of specs (a reference
    ``PartitionSpec`` is a tuple subclass: a leaf here)."""
    if isinstance(t, dict):
        return {k: map_specs(fn, v, k) for k, v in t.items()}
    if isinstance(t, list) or type(t) is tuple:
        return type(t)(map_specs(fn, v, name) for v in t)
    return fn(name, t)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)], ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_as_reference(arch, shape):
    from repro import configs as j_configs
    from repro.distributed import sharding as j_sharding
    from repro.models import convnext as j_cn
    from repro.models import dit as j_dit
    from repro.models import efficientnet as j_eff
    from repro.models import vit as j_vit

    j_mod = {"vit-h14": j_vit, "dit-xl2": j_dit, "convnext-b": j_cn,
             "efficientnet-b7": j_eff}[arch]
    mod = MODS[arch]
    jr = j_sharding.rules_for_mesh(stand_in(shape))
    tr = sharding.rules_for_mesh(stand_in(shape))
    for size in ("smoke", "full"):
        want = j_mod.param_specs(getattr(j_configs.get(arch), size), jr)
        got = mod.param_specs(getattr(t_configs.get(arch), size), tr)
        conv = getattr(mod, "CONV_LEAVES", ())
        want = map_specs(lambda name, s: tuple(
            zoo_mesh.conv_spec(s) if name in conv else s), want)
        assert map_specs(lambda _, s: tuple(s), got) == want, (arch, size)
    # the shapes the specs cut: every cut dim divides
    full = mod.abstract_params(t_configs.get(arch).full)
    for t, s in zip(tree.leaves(full), tree.leaves(
            mod.param_specs(t_configs.get(arch).full, tr))):
        assert len(s) == t.dim() and t.device.type == "meta"
        for n, e in zip(t.shape, s):
            assert e is None or n % tr.axis_size(e) == 0


# --------------------------------------------------------------------------
# The new collectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(4), ids=["reduce_scatter_model",
                                             "row_parallel_scatter",
                                             "sum_stats",
                                             "gather_model_leaves"])
def test_each_new_backward_is_its_forwards_transpose(ranks, i):
    lhs = sum(r["adjoint"][i][1] for r in ranks)
    rhs = sum(r["adjoint"][i][2] for r in ranks)
    assert abs(lhs - rhs) <= ADJOINT_TOL * max(abs(lhs), 1.0), \
        (ranks[0]["adjoint"][i][0], lhs, rhs)


# --------------------------------------------------------------------------
# Each arch against the reference and one device
# --------------------------------------------------------------------------

CASES = [(a, s) for a in ARCHS for s in MESHES]
CASE_IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]


def check_leaves(got, want, tol, floor=GRAD_FLOOR):
    total = np.sqrt(sum(float(np.square(np.asarray(w, np.float64)).sum())
                        for w in want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        gap = float(np.linalg.norm(np.asarray(a, np.float64) - b))
        assert gap <= tol * max(float(np.linalg.norm(b)), floor * total), \
            (i, gap, float(np.linalg.norm(b)))


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_sharded_against_reference(ranks, jax_side, arch, shape):
    """bf16 against the reference on (1, 1) (EfficientNet: both float32
    compute, caveat (i))."""
    loss, leaves, _, _ = ranks[0]["case", arch, shape][
        1 if arch == "efficientnet-b7" else 0]
    want_loss, want = jax_side[arch]
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    for r in ranks:
        assert r["case", arch, shape][0][0] == ranks[0]["case", arch,
                                                        shape][0][0]
    check_leaves(conv_to_hwio(arch, leaves, leaf_paths(arch)), want,
                 GRAD_TOL)


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_sharded_against_one_device(ranks, single, arch, shape):
    """bf16 against the port's one-device path: loss, each leaf, the
    serving output."""
    loss, leaves, out, _ = ranks[0]["case", arch, shape][0]
    want_loss, want, want_out, _ = single[arch][0]
    eff = arch == "efficientnet-b7"
    assert abs(loss - want_loss) <= (LOSS_TOL if eff else SINGLE_LOSS_TOL) \
        * abs(want_loss)
    check_leaves(leaves, want, EFF_SINGLE_TOL if eff else SINGLE_GRAD_TOL)
    assert rel_max(out, want_out) <= SINGLE_OUT_TOL


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_float32_sharded_equals_one_device(ranks, single, arch, shape):
    loss, leaves, out, _ = ranks[0]["case", arch, shape][1]
    want_loss, want, want_out, _ = single[arch][1]
    assert abs(loss - want_loss) <= F32_TOL * abs(want_loss)
    check_leaves(leaves, want, F32_TOL)
    assert rel_max(out, want_out) <= F32_TOL


# --------------------------------------------------------------------------
# DiT's layouts, remat and sampling
# --------------------------------------------------------------------------

def test_dit_seq_shard_off_and_on(ranks, single):
    """The whole residual and the Megatron-SP one: the same function."""
    loss, leaves, out, _ = ranks[0]["dit"]["seq_off"]
    want_loss, want, want_out, _ = single["dit-xl2"][1]
    assert abs(loss - want_loss) <= F32_TOL * abs(want_loss)
    assert all(rel_l2(a, b) <= F32_TOL for a, b in zip(leaves, want))
    assert rel_max(out, want_out) <= F32_TOL


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "float32"])
def test_dit_batch_that_does_not_divide_data(ranks, single, f32):
    """A batch of 1 on (2, 2): its tokens over ``data``."""
    loss, leaves, out, _ = ranks[0]["dit"]["one"][int(f32)]
    want_loss, want, want_out, _ = single["dit_one"][int(f32)]
    tol = F32_TOL if f32 else SINGLE_GRAD_TOL
    assert abs(loss - want_loss) <= (F32_TOL if f32 else LOSS_TOL) \
        * abs(want_loss)
    assert all(rel_l2(a, b) <= tol for a, b in zip(leaves, want))
    assert rel_max(out, want_out) <= (F32_TOL if f32 else SINGLE_OUT_TOL)


def test_dit_dots_equals_nothing(ranks):
    for r in ranks:
        nothing, dots = r["dit"]["remat"]["nothing"], r["dit"]["remat"][
            "dots"]
        assert nothing[0] == dots[0]
        # "dots" keeps each row-parallel product (and its reduce-scatter)
        assert dots[2] < nothing[2]
    nothing, dots = (ranks[0]["dit"]["remat"][k] for k in ("nothing",
                                                           "dots"))
    assert all(np.array_equal(a, b) for a, b in zip(nothing[1], dots[1]))


def test_dit_sample_step_whole_on_every_rank(ranks, single):
    got = ranks[0]["dit"]["sample"]
    assert got.shape == single["sample"].shape
    assert rel_max(got, single["sample"]) <= SINGLE_OUT_TOL


# --------------------------------------------------------------------------
# EfficientNet's synced batch norm; ViT's binary step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_effnet_running_stats_synced(ranks, single, shape):
    """The new BN state of the float32 step 0: each rank's block of every
    running statistic equal to its data peer's bit for bit (on (2, 2)),
    and the blocks put together within F32_TOL of one device's."""
    states = [r["case", "efficientnet-b7", shape][1][3] for r in ranks]
    if shape == (2, 2):   # ranks 0, 1 and 2, 3: the model groups of data 0, 1
        for a, b in ((0, 2), (1, 3)):
            for x, y in zip(states[a][0], states[b][0]):
                assert np.array_equal(x, y)
    for got, want in zip(states[0][1], single["efficientnet-b7"][1][3][1]):
        assert rel_l2(got, want) <= F32_TOL


def test_vit_binary_step_clips_latents(ranks, single):
    _, got = ranks[0]["binary"]
    paths = leaf_paths("vit-h14")
    for path, a, b in zip(paths, got, single["binary"]):
        assert np.abs(a - b).max() <= 2 * BINARY_LR * 1.001 + 1e-6, path
        if any(f"['{n}']" in path for n in ("wqkv", "wo", "w1", "w2")):
            assert np.abs(a).max() <= 1.0, path
