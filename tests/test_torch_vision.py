"""Port parity: the vision zoo — ViT (L/16, H/14), ConvNeXt-B and
EfficientNet-B7 — and the registry of all ten archs.

Both packages get the same numpy inputs and parameters.  Every parameter
and state leaf is drawn from a numpy seed at O(1) scale around the
reference's init (``randomize``, around values the port's ``init_params`` draws, in the
reference's tree and shapes): the reference zero-initialises biases
and sets ConvNeXt's layer scale to 1e-6 and EfficientNet's BN statistics to
0/1, so a check at init values would prove little.  The reference runs as
``tests/test_arch_smoke.py`` runs it (a one-device host mesh), jitted with
``xla_allow_excess_precision`` off (``tests/test_torch_train.py``'s
``exact_jit``), so that its bf16 roundings are the eager ones; the port
runs with ``device="cpu"``, where K7 and K7b take their plain versions.
Both compute in bf16.  What each case holds, and why:

* configs: all ten archs' FULL, SMOKE, FAMILY and SHAPES equal the
  reference's field by field, the zoo's parameter counts too;
* exact helpers: ``round_filters``, ``round_repeats``, ``stages()``;
  ``resize_pos_embed`` at 14→24, 16→27 and 16→64 within ``RESIZE_TOL``
  (``F.interpolate`` against ``jax.image.resize``: the same weights, float32
  sums in another order; on N(0, 1) tables of width 1280 the largest gap
  measured 1.7e-6, 2.1e-6, and 4.8e-7 at 16→32 and 16→64, about half the
  values equal bit for bit); XLA's "SAME" padding at stride 2 (asymmetric)
  against ``lax.conv_general_dilated`` at even and odd sizes;
* forward: logits within ``LOGIT_TOL`` (max error over max |reference|) of
  the float variants: bf16 rounds at other places (GELU in one rounding
  against the reference's op-by-op bf16, conv and matmul sums in other
  orders), a few bf16 steps (measured 3e-3 to 1e-2); the binary variants
  within ``BINARY_TOL`` (measured 0 to 2e-4): their GELU and SiLU are the
  reference's op by op (``layers.gelu(exact=True)``), since a sign that
  flips near 0 moves a binary net's output by O(1);
* one train step: the loss within ``LOSS_TOL``, the gradient norm within
  ``GNORM_TOL``, each leaf's gradient (AdamW's first moment, or SGDM's
  momentum) within ``GRAD_TOL`` relative L2 (a leaf whose gradient is
  0 in exact arithmetic, as a bias under a train-mode BN, is held to the
  tree's scale), and every parameter after an AdamW step within 2·lr of
  the reference's (AdamW's first step moves each element by lr·sign(g):
  an element whose gradient is ~0 may take the other sign);  with the
  binary variants at lr 1, the latent leaves the reference's path
  predicate picks stay within [-1, 1] in both packages, the same ones
  reach the bound in both, and leaves outside it pass 1;
* EfficientNet's BN: eval-mode logits; train-mode logits and the new BN
  state; one SGDM step (params, state, momentum).  Train-mode BN
  normalises by the batch: where a channel has few values (the last
  stages are 1×1 at the SMOKE resolution of 32, batch 2) a rounding step
  in the input is amplified by 1 / std — the reference's own logits move
  by 127% when the last bf16 bit of 1% of the input pixels flips (1.4% at
  2 × 128²).  So the float variant's train mode is held at 2 × 128²,
  where it is conditioned: the logits within ``EFF_TRAIN_TOL`` (measured
  2.0e-2), the momentum within ``EFF_MOMENTUM_TOL`` over the tree
  (measured 0.11) and each leaf within ``EFF_LEAF_TOL`` of its own norm
  or of ``GRAD_FLOOR`` of the tree's (measured 0.18 at worst, a BN
  scale); the binary variant,
  whose elementwise ops are the reference's bits, at 2 × 32² (measured
  3.6e-3, 8e-3): at 128² one float32 batch statistic summed in another
  order flips a sign near 0, after which the two binary nets part by
  O(1) (also the reference against itself).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as j_configs
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import convnext as j_cn
from repro.models import efficientnet as j_eff
from repro.models import vit as j_vit
from repro.optim import optimizers as j_opt
from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.models import convnext as t_cn
from repro_torch.models import efficientnet as t_eff
from repro_torch.models import layers as t_layers
from repro_torch.models import vit as t_vit
from repro_torch.optim import optimizers as t_opt

LOGIT_TOL = 2e-2
BINARY_TOL = 1e-3
LOSS_TOL = 5e-3
GNORM_TOL = 2e-2
GRAD_TOL = 5e-2
# A leaf's gradient gap is held to GRAD_TOL of its own norm or of this
# share of the tree's, whichever is larger.
GRAD_FLOOR = 0.05
RESIZE_TOL = 1e-5
EFF_TRAIN_TOL = 5e-2
EFF_MOMENTUM_TOL = 0.2
EFF_LEAF_TOL = 0.4

ZOO = ("dit-l2", "dit-xl2", "efficientnet-b7", "convnext-b", "vit-l16",
       "vit-h14")


@pytest.fixture(scope="module")
def mesh_rules():
    mesh = make_host_mesh(data=1, model=1)
    return mesh, rules_for_mesh(mesh)


def exact_jit(fn, *args):
    """``fn`` compiled with every bf16 intermediate rounded, as eager ops
    round them."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


def randomize(ref_tree, seed):
    """Every leaf of the reference's init drawn anew at O(1) scale around
    it: plus N(0, (s/2)²) for a leaf of spread s, N(0, 0.2²) for a constant
    one (zeros, ones, a layer scale); BN variances exp(N(0, 0.3²))."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return np.exp(0.3 * rng.standard_normal(a.shape)).astype(
                np.float32)
        sd = float(a.std()) if a.size > 1 else 0.0
        s = 0.5 * sd if sd > 0 else 0.2
        return (a + s * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, ref_tree)


def init_numpy(t_mod, t_cfg, j_init, j_cfg, seed):
    """Parameters (and state) at init, as numpy in the reference's layouts,
    randomized: drawn by the port's ``init_params`` from ``seed`` (the
    reference's eager init compiles a kernel for each of its hundreds of
    shapes), held to the reference's tree and shapes by ``jax.eval_shape``
    of its ``init_params``."""
    def to_ref(t, name=""):
        if isinstance(t, dict):
            return {k: to_ref(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(to_ref(v, name) for v in t)
        if name in getattr(t_mod, "CONV_LEAVES", ()):
            t = t_layers.oihw_to_hwio(t)
        return t.float().numpy()
    tree_np = to_ref(t_mod.init_params(
        t_cfg, torch.Generator().manual_seed(seed), "cpu"))
    want = jax.eval_shape(lambda k: j_init(k, j_cfg), jax.random.key(0))
    assert jax.tree.structure(tree_np) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(tree_np)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return randomize(tree_np, seed)


def rel_max(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def pairs(port_tree, ref_tree, conv=frozenset()):
    """(path, port leaf, reference leaf) as float32 numpy, the port's
    (O, I, KH, KW) kernels back in HWIO."""
    out = []
    for (path, a), b in zip(tree.flatten_with_paths(port_tree),
                            jax.tree.leaves(ref_tree)):
        if any(f"['{c}']" in path for c in conv):
            a = t_layers.oihw_to_hwio(a)
        a = a.detach().float().numpy()
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        out.append((path, a, b))
    return out


def check_grads(port_tree, ref_tree, conv=frozenset(), tol=GRAD_TOL):
    ps = pairs(port_tree, ref_tree, conv)
    total = math.sqrt(sum(float(np.square(b).sum()) for _, _, b in ps))
    for path, a, b in ps:
        gap = float(np.linalg.norm(a - b))
        assert gap <= tol * max(float(np.linalg.norm(b)),
                                GRAD_FLOOR * total), (path, gap)


def global_gap(port_tree, ref_tree, conv=frozenset()) -> float:
    ps = pairs(port_tree, ref_tree, conv)
    return math.sqrt(sum(float(np.square(a - b).sum()) for _, a, b in ps)
                     / sum(float(np.square(b).sum()) for _, _, b in ps))


def t_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def check_adamw_step(tp2, jp2, tm, jm, lr, conv, clip_names=None):
    """Loss, gradient norm, every parameter within 2·lr; with
    ``clip_names`` the latent leaves clipped to [-1, 1] are exactly those
    named, in both packages."""
    want = float(jm["loss"])
    assert abs(tm["loss"].item() - want) <= LOSS_TOL * abs(want)
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
        GNORM_TOL * float(jm["grad_norm"])
    top = {}
    for path, a, b in pairs(tp2, jp2, conv):
        assert np.abs(a - b).max() <= 2 * lr * 1.001 + 1e-6, path
        top[path] = (float(np.abs(a).max()), float(np.abs(b).max()))
    if clip_names is not None:
        named = {p for p in top if any(f"['{n}']" in p for n in clip_names)}
        assert all(max(top[p]) <= 1.0 for p in named)
        at_bound = {p for p in named if top[p][1] == 1.0}
        assert at_bound and at_bound == {p for p in named
                                         if top[p][0] == 1.0}
        assert any(min(top[p]) > 1.0 for p in top if p not in named)


# --------------------------------------------------------------------------
# Configs and exact helpers
# --------------------------------------------------------------------------

def test_all_configs_as_reference():
    """All ten archs: FULL, SMOKE, FAMILY and SHAPES equal the reference's
    field by field; the zoo's parameter counts (EfficientNet's from its
    shapes, nothing allocated); ``shape(name)``; the 40 cells."""
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    for arch in t_configs.ARCH_IDS:
        port, ref = t_configs.get(arch), j_configs.get(arch)
        assert port.family == ref.family
        assert [vars(s) for s in port.shapes] == [vars(s) for s in ref.shapes]
        for p, r in ((port.full, ref.full), (port.smoke, ref.smoke)):
            assert type(p).__name__ == type(r).__name__
            assert vars(p) == vars(r)
    for arch in ZOO:
        port, ref = t_configs.get(arch), j_configs.get(arch)
        assert port.full.param_count() == ref.full.param_count(), arch
        name = "serve_b1" if port.family == "vision" else "gen_fast"
        assert vars(port.shape(name)) == vars(ref.shape(name))
    assert t_configs.get("vit-h14").full.d_head == 80
    assert t_configs.get("dit-xl2").full.d_head == 72
    assert [(a, vars(s)) for a, s in t_configs.all_cells()] == \
        [(a, vars(s)) for a, s in j_configs.all_cells()]
    with pytest.raises(KeyError, match="no shape"):
        t_configs.get("vit-l16").shape("train_4k")
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get("resnet-50")


@pytest.mark.parametrize("arch", ["efficientnet-b7"])
def test_effnet_scaling_helpers(arch):
    rec_t, rec_j = t_configs.get(arch), j_configs.get(arch)
    for cfg_t, cfg_j in ((rec_t.full, rec_j.full), (rec_t.smoke,
                                                    rec_j.smoke)):
        assert cfg_t.stages() == cfg_j.stages()
        assert (cfg_t.stem_ch, cfg_t.head_ch) == (cfg_j.stem_ch,
                                                  cfg_j.head_ch)
    assert sum(s[5] for s in rec_t.full.stages()) == 55
    for c in (8, 16, 24, 32, 40, 80, 112, 192, 320, 1280):
        for w in (0.5, 1.0, 1.1, 2.0):
            assert t_eff.round_filters(c, w) == j_eff.round_filters(c, w)
    for r in range(1, 6):
        for d in (0.4, 1.0, 2.2, 3.1):
            assert t_eff.round_repeats(r, d) == j_eff.round_repeats(r, d)


@pytest.mark.parametrize("grids", [(14, 24), (16, 27), (16, 64)])
def test_resize_pos_embed(grids):
    """The position table enlarged as ViT at 384 (L/16: 14→24, H/14:
    16→27) and DiT at gen_1024 (16→64) enlarge it."""
    g0, g1 = grids
    pos = np.random.default_rng(g1).standard_normal(
        (g0 * g0 + 1, 24)).astype(np.float32)
    want = np.asarray(j_vit.resize_pos_embed(jnp.asarray(pos), g0, g1))
    got = t_vit.resize_pos_embed(torch.from_numpy(pos), g0, g1).numpy()
    assert got.shape == (g1 * g1 + 1, 24)
    np.testing.assert_array_equal(got[0], pos[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)
    assert t_vit.resize_pos_embed(torch.from_numpy(pos), g0,
                                  g0).data_ptr() is not None


@pytest.mark.parametrize("size,k", [(16, 3), (15, 3), (8, 5), (9, 5),
                                    (7, 3)])
def test_same_padding_stride2(size, k):
    """XLA's "SAME" at stride 2 pads (total // 2, rest): 16 → 8 with k 3
    pads (0, 1), 8 → 4 with k 5 (1, 2); the port's depthwise and stem
    convs against ``lax.conv_general_dilated`` in float32."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 6)).astype(np.float32)
    for groups, w_shape in ((6, (k, k, 1, 6)), (1, (k, k, 6, 4))):
        w = rng.standard_normal(w_shape).astype(np.float32)
        want = lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups)
        got = t_eff.conv_same(torch.from_numpy(x),
                              t_layers.hwio_to_oihw(torch.from_numpy(w)),
                              stride=2, groups=groups)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert t_eff.same_pads(16, 3, 2) == (0, 1)
    assert t_eff.same_pads(8, 5, 2) == (1, 2)


# --------------------------------------------------------------------------
# ViT
# --------------------------------------------------------------------------

VIT_CASES = [(a, b) for a in ("vit-l16", "vit-h14") for b in (False, True)]


def vit_case(arch, binary, seed=0):
    j_cfg = dataclasses.replace(j_configs.get(arch).smoke,
                                binary_dense=binary)
    t_cfg = dataclasses.replace(t_configs.get(arch).smoke,
                                binary_dense=binary)
    npp = init_numpy(t_vit, t_cfg, j_vit.init_params, j_cfg, seed)
    return (j_cfg, t_cfg, jax.tree.map(jnp.asarray, npp),
            t_vit.params_from_numpy(npp, t_cfg, "cpu"))


@pytest.mark.parametrize("arch,binary", VIT_CASES,
                         ids=[f"{a}-{'binary' if b else 'float'}"
                              for a, b in VIT_CASES])
def test_vit_logits(arch, binary, mesh_rules):
    """Logits at the config's resolution and at twice it (the position
    table resized, as cls_384 does)."""
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp = vit_case(arch, binary)
    rng = np.random.default_rng(1)
    for res in (j_cfg.img_res, 2 * j_cfg.img_res):
        x = rng.random((2, res, res, 3), dtype=np.float32)
        with mesh:
            want = exact_jit(lambda p, x: j_vit.forward(p, x, j_cfg, rules),
                             jp, x)(jp, x)
        got = t_vit.forward(tp, torch.from_numpy(x), t_cfg)
        assert got.dtype == torch.bfloat16 and got.is_inference()
        assert rel_max(got, want) <= (BINARY_TOL if binary else LOGIT_TOL)


@pytest.mark.parametrize("arch,binary", VIT_CASES,
                         ids=[f"{a}-{'binary' if b else 'float'}"
                              for a, b in VIT_CASES])
def test_vit_train_step(arch, binary, mesh_rules):
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp = vit_case(arch, binary, seed=2)
    rng = np.random.default_rng(3)
    r = j_cfg.img_res
    batch = {"images": rng.random((2, r, r, 3), dtype=np.float32),
             "labels": rng.integers(0, j_cfg.n_classes, (2,)).astype(
                 np.int32)}
    lr = 1.0 if binary else 1e-3
    jb = jax.tree.map(jnp.asarray, batch)
    with mesh:
        js = j_opt.adamw_init(jp)
        step = exact_jit(j_vit.make_train_step(j_cfg, rules, lr=lr), jp, js,
                         jb)
        jp2, js2, jm = step(jp, js, jb)
    tp2, ts2, tm = t_vit.make_train_step(t_cfg, lr=lr)(
        tp, t_opt.adamw_init(tp), t_batch(batch))
    check_grads(ts2.mu, js2.mu, t_vit.CONV_LEAVES)
    check_adamw_step(tp2, jp2, tm, jm, lr, t_vit.CONV_LEAVES,
                     ("wqkv", "wo", "w1", "w2") if binary else None)


# --------------------------------------------------------------------------
# ConvNeXt
# --------------------------------------------------------------------------

def convnext_case(binary, seed=0):
    j_cfg = dataclasses.replace(j_configs.get("convnext-b").smoke,
                                binary_pointwise=binary)
    t_cfg = dataclasses.replace(t_configs.get("convnext-b").smoke,
                                binary_pointwise=binary)
    npp = init_numpy(t_cn, t_cfg, j_cn.init_params, j_cfg, seed)
    return (j_cfg, t_cfg, jax.tree.map(jnp.asarray, npp),
            t_cn.params_from_numpy(npp, t_cfg, "cpu"))


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_convnext_logits(binary, mesh_rules):
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp = convnext_case(binary)
    x = np.random.default_rng(4).random((2, 32, 32, 3), dtype=np.float32)
    with mesh:
        want = exact_jit(lambda p, x: j_cn.forward(p, x, j_cfg, rules), jp,
                         x)(jp, x)
    got = t_cn.forward(tp, torch.from_numpy(x), t_cfg)
    assert got.dtype == torch.float32
    assert rel_max(got, want) <= (BINARY_TOL if binary else LOGIT_TOL)


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_convnext_train_step(binary, mesh_rules):
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, tp = convnext_case(binary, seed=5)
    batch = {"images": np.random.default_rng(6).random(
        (2, 32, 32, 3), dtype=np.float32),
        "labels": np.array([3, 7], np.int32)}
    lr = 1.0 if binary else 4e-3
    jb = jax.tree.map(jnp.asarray, batch)
    with mesh:
        js = j_opt.adamw_init(jp)
        step = exact_jit(j_cn.make_train_step(j_cfg, rules, lr=lr), jp, js,
                         jb)
        jp2, js2, jm = step(jp, js, jb)
    tp2, ts2, tm = t_cn.make_train_step(t_cfg, lr=lr)(
        tp, t_opt.adamw_init(tp), t_batch(batch))
    check_grads(ts2.mu, js2.mu, t_cn.CONV_LEAVES)
    check_adamw_step(tp2, jp2, tm, jm, lr, t_cn.CONV_LEAVES,
                     ("w1", "w2") if binary else None)


# --------------------------------------------------------------------------
# EfficientNet
# --------------------------------------------------------------------------

def effnet_case(binary, seed=0):
    j_cfg = dataclasses.replace(j_configs.get("efficientnet-b7").smoke,
                                binary_pointwise=binary)
    t_cfg = dataclasses.replace(t_configs.get("efficientnet-b7").smoke,
                                binary_pointwise=binary)
    npp = init_numpy(t_eff, t_cfg, j_eff.init_params, j_cfg, seed)
    jp, js = jax.tree.map(jnp.asarray, npp)
    tp, ts = t_eff.params_from_numpy(npp, t_cfg, "cpu")
    return j_cfg, t_cfg, jp, js, tp, ts


# (batch, resolution) of the train-mode cases: see the module docstring.
EFF_TRAIN_INPUT = {False: (2, 128), True: (2, 32)}


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_effnet_eval_logits(binary, mesh_rules):
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, js, tp, ts = effnet_case(binary)
    x = np.random.default_rng(7).random((2, 32, 32, 3), dtype=np.float32)
    with mesh:
        want, _ = exact_jit(
            lambda p, s, x: j_eff.apply(p, s, x, j_cfg, rules, train=False),
            jp, js, x)(jp, js, x)
    got, new_state = t_eff.apply(tp, ts, torch.from_numpy(x), t_cfg,
                                 train=False)
    assert got.dtype == torch.float32 and got.is_inference()
    assert rel_max(got, want) <= (BINARY_TOL if binary else LOGIT_TOL)
    for _, a, b in pairs(new_state, js):              # stats unchanged
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_effnet_train_mode_logits_and_state(binary, mesh_rules):
    """Batch statistics: the logits and the running stats moved 1% toward
    the batch's mean and population variance."""
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, js, tp, ts = effnet_case(binary, seed=8)
    n, r = EFF_TRAIN_INPUT[binary]
    x = np.random.default_rng(9).random((n, r, r, 3), dtype=np.float32)
    with mesh:
        want, want_state = exact_jit(
            lambda p, s, x: j_eff.apply(p, s, x, j_cfg, rules, train=True),
            jp, js, x)(jp, js, x)
    got, got_state = t_eff.apply(tp, ts, torch.from_numpy(x), t_cfg,
                                 train=True)
    assert rel_max(got, want) <= (LOGIT_TOL if binary else EFF_TRAIN_TOL)
    moved = 0
    for (_, a, b), (_, old, _) in zip(pairs(got_state, want_state),
                                      pairs(ts, js)):
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b)
        moved += int(not np.array_equal(a, old))
    assert moved == len(tree.leaves(ts))


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_effnet_sgdm_step(binary, mesh_rules):
    """One SGDM step: loss, params, BN state and momentum (g + wd·p, so the
    gradient) against the reference's."""
    mesh, rules = mesh_rules
    j_cfg, t_cfg, jp, js, tp, ts = effnet_case(binary, seed=10)
    n, r = EFF_TRAIN_INPUT[binary]
    batch = {"images": np.random.default_rng(11).random(
        (n, r, r, 3), dtype=np.float32),
        "labels": np.arange(n, dtype=np.int32)}
    jb = jax.tree.map(jnp.asarray, batch)
    with mesh:
        jo = j_opt.sgdm_init(jp)
        step = exact_jit(j_eff.make_train_step(j_cfg, rules), jp, js, jo, jb)
        jp2, js2, jo2, jm = step(jp, js, jo, jb)
    tp2, ts2, to2, tm = t_eff.make_train_step(t_cfg)(
        tp, ts, t_opt.sgdm_init(tp), t_batch(batch))
    want = float(jm["loss"])
    assert abs(tm["loss"].item() - want) <= LOSS_TOL * abs(want)
    assert int(to2.step) == 1 and to2.nu is None
    tol = GRAD_TOL if binary else EFF_MOMENTUM_TOL
    assert global_gap(to2.mu, jo2.mu, t_eff.CONV_LEAVES) <= tol
    check_grads(to2.mu, jo2.mu, t_eff.CONV_LEAVES,
                GRAD_TOL if binary else EFF_LEAF_TOL)
    # the step: p - lr·(g + wd·p), against the reference's
    assert global_gap(tree.tree_map(lambda a, b: a - b, tp2, tp),
                      jax.tree.map(lambda a, b: a - b, jp2, jp),
                      t_eff.CONV_LEAVES) <= tol
    assert global_gap(ts2, js2) <= 1e-2
    assert all(not torch.equal(a, b) for a, b in zip(tree.leaves(ts2),
                                                     tree.leaves(ts)))
