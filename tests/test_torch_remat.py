"""Per-layer remat (``layers.scan_layers`` under ``REMAT_POLICIES``) in
every train step of the port, on the CPU at SMOKE sizes.

Remat changes what a train step keeps for its backward, never what it
computes: the recompute runs the same ops on the same inputs.  So each
family's loss, gradients and auxiliary outputs (the MoE balance loss,
EfficientNet's new BN statistics) are held bit for bit against the same
step with ``layers.scan_layers`` patched to ``remat=False``.  What remat
does change is held too: the bytes the autograd graph saves outside the
checkpointed layers no longer grow with depth; under "dots" the
selective policy keeps exactly a layer's matrix products and the backward
dispatches none of them again, where under "nothing" it reruns them all;
attention's forward (K7's plain version here) runs twice a layer and its
backward once; a serving forward under ``torch.inference_mode`` takes no
checkpoint; and "dots" raises where torch lacks selective checkpointing
rather than run "nothing".  The JAX package is not needed: the parity
tests of each family (``test_torch_train.py``, ``test_torch_vision.py``,
``test_torch_dit.py``) hold the remat path against it.
"""

import collections
import dataclasses

import pytest
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, tree
from repro_torch.data import ImagePipeline, LatentPipeline, TokenPipeline
from repro_torch.kernels import flash_attention as k7
from repro_torch.models import convnext, dit, efficientnet, layers, \
    transformer, vit
from repro_torch.optim import sgdm_init

FAMILIES = ("lm-dense", "lm-moe", "vit", "dit-dots", "dit-nothing",
            "convnext", "efficientnet")
# The families whose layers run attention (K7 under autograd).
ATTENTION = ("lm-dense", "lm-moe", "vit", "dit-dots", "dit-nothing")


def _perturbed(params, seed: int):
    """Every leaf plus N(0, 0.02²): DiT's adaLN-zero leaves start at 0,
    where no gradient would reach attention."""
    g = torch.Generator().manual_seed(seed)
    return tree.tree_map(
        lambda t: t + 0.02 * torch.randn(t.shape, generator=g), params)


def case(family: str, n_layers: int | None = None):
    """(loss_fn, params, args, layers checkpointed a step) of one family's
    SMOKE config at ``n_layers`` (its own depth when None)."""
    g = torch.Generator().manual_seed(0)
    if family.startswith("lm"):
        arch = "minitron-8b" if family == "lm-dense" else \
            "granite-moe-3b-a800m"
        cfg = configs.get(arch).smoke
        cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
        params = transformer.init_params(cfg, g, "cpu", dtype=torch.float32)
        batch = TokenPipeline(seed=0, batch=2, seq_len=16, vocab=cfg.vocab,
                              device="cpu").batch_at(0)
        return transformer.loss_fn, params, (batch, cfg), cfg.n_layers
    if family == "vit":
        cfg = configs.get("vit-l16").smoke
        cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
        params = _perturbed(vit.init_params(cfg, g, "cpu"), 1)
        batch = ImagePipeline(seed=0, batch=2, img_res=cfg.img_res,
                              n_classes=cfg.n_classes, device="cpu",
                              prefetch=0).batch_at(0)
        return vit.loss_fn, params, (batch, cfg), cfg.n_layers
    if family.startswith("dit"):
        cfg = configs.get("dit-l2").smoke
        cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                                  remat_policy=family.split("-")[1])
        params = _perturbed(dit.init_params(cfg, g, "cpu"), 1)
        batch = LatentPipeline(seed=0, batch=2, latent_res=cfg.latent_res(),
                               n_classes=cfg.n_classes, device="cpu",
                               prefetch=0).batch_at(0)
        return dit.train_loss, params, (batch, cfg), cfg.n_layers
    if family == "convnext":
        cfg = configs.get("convnext-b").smoke
        params = _perturbed(convnext.init_params(cfg, g, "cpu"), 1)
        batch = ImagePipeline(seed=0, batch=2, img_res=cfg.img_res,
                              n_classes=cfg.n_classes, device="cpu",
                              prefetch=0).batch_at(0)
        return convnext.loss_fn, params, (batch, cfg), sum(cfg.depths)
    cfg = configs.get("efficientnet-b7").smoke
    params, state = efficientnet.init_params(cfg, g, "cpu")
    batch = ImagePipeline(seed=0, batch=2, img_res=cfg.img_res,
                          n_classes=cfg.n_classes, device="cpu",
                          prefetch=0).batch_at(0)
    rest = sum(r - 1 for *_, r in cfg.stages())
    return (efficientnet.loss_fn, _perturbed(params, 1), (state, batch, cfg),
            rest)


def plain_loop(monkeypatch) -> None:
    """``layers.scan_layers`` with ``remat=False`` whatever its caller
    asks: the loop the port ran before remat."""
    scan = layers.scan_layers
    monkeypatch.setattr(layers, "scan_layers",
                        lambda *a, **kw: scan(*a, **{**kw, "remat": False}))


def count_calls(monkeypatch, module, name: str) -> list:
    """Wrap ``module.name`` to append each call's keyword arguments to the
    returned list."""
    calls, fn = [], getattr(module, name)

    def spy(*a, **kw):
        calls.append(kw)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def assert_trees_equal(got, want) -> None:
    got_l, want_l = tree.flatten_with_paths(got), tree.leaves(want)
    assert len(got_l) == len(want_l)
    for (path, a), b in zip(got_l, want_l):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_step_equals_the_plain_loop(family, monkeypatch):
    """Loss, every gradient leaf and the auxiliary outputs bit for bit;
    the remat step checkpoints every layer (or block) once."""
    loss_fn, params, args, n_ckpt = case(family)
    with monkeypatch.context() as m:
        ckpts = count_calls(m, torch.utils.checkpoint, "checkpoint")
        (loss, aux), grads = tree.value_and_grad(loss_fn, params, *args)
    assert len(ckpts) == n_ckpt
    assert all(kw["use_reentrant"] is False
               and kw["preserve_rng_state"] is False for kw in ckpts)
    plain_loop(monkeypatch)
    (loss_p, aux_p), grads_p = tree.value_and_grad(loss_fn, params, *args)
    assert torch.isfinite(loss) and torch.equal(loss, loss_p)
    assert_trees_equal(grads, grads_p)
    assert_trees_equal(aux, aux_p)
    assert any(g.abs().max() > 0 for g in tree.leaves(grads))


def test_effnet_bn_statistics_move_once(monkeypatch):
    """The new BN statistics come out of the checkpointed blocks as
    outputs: equal to the plain loop's, moved from the old state, which
    stays as it was (the recompute in the backward moves nothing)."""
    loss_fn, params, (state, batch, cfg), _ = case("efficientnet")
    old = tree.tree_map(torch.clone, state)
    step = efficientnet.make_train_step(cfg)
    opt = sgdm_init(params)
    _, new_state, _, _ = step(params, state, opt, batch)
    assert_trees_equal(state, old)
    plain_loop(monkeypatch)
    _, new_plain, _, _ = step(params, state, opt, batch)
    assert_trees_equal(new_state, new_plain)
    rest = new_state["stages"][-2]["rest"]
    assert not torch.equal(rest["dw_bn"]["mean"],
                           old["stages"][-2]["rest"]["dw_bn"]["mean"])


def saved_bytes(loss_fn, params, args) -> int:
    """Bytes of the distinct storages the autograd graph of the loss saves
    where an outer ``saved_tensors_hooks`` pair sees them (a checkpointed
    layer saves under its own hooks)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    flat = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(tree.unflatten(params, flat), *args)
    del loss
    return sum(seen.values())


# Elements of one layer's input (B, S, D), bf16, at each case's SMOKE size.
BOUNDARY = {"lm-dense": 2 * 16 * 64, "vit": 2 * 17 * 32,
            "dit-dots": 2 * 16 * 64}


@pytest.mark.parametrize("family", tuple(BOUNDARY))
def test_saved_bytes_flat_in_depth(family, monkeypatch):
    """SMOKE at 2 and 4 layers: under remat the saved bytes grow by the two
    added layers' inputs alone (the boundaries the non-reentrant
    checkpoint keeps to recompute from: nothing inside a layer), without
    it by the layers' activations."""
    remat = [saved_bytes(*case(family, n)[:3]) for n in (2, 4)]
    plain_loop(monkeypatch)
    plain = [saved_bytes(*case(family, n)[:3]) for n in (2, 4)]
    assert remat[1] - remat[0] == 2 * 2 * BOUNDARY[family]
    assert plain[1] - plain[0] > 4 * (remat[1] - remat[0])


class DotRecorder(TorchDispatchMode):
    """Records each matrix product dispatched under it: (op, argument
    shapes)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in layers.DOT_OPS:
            self.ops.append(op_key(func, args))
        return func(*args, **(kwargs or {}))


def op_key(op, args) -> tuple:
    return str(op), tuple(tuple(a.shape) for a in args
                          if isinstance(a, torch.Tensor))


def products_in_backward(loss_fn, params, args) -> list:
    """The matrix products dispatched while the loss's gradients are taken:
    the backward's own and any the recompute runs (a product whose output
    the selective checkpoint kept is read back, never dispatched)."""
    flat = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tree.unflatten(params, flat), *args)
        with DotRecorder() as r:
            torch.autograd.grad(loss, flat, allow_unused=True)
    return r.ops


def layer_products(loss_fn, params, args, monkeypatch) -> list:
    """The matrix products each layer's body runs in the forward, a list a
    layer."""
    per_layer, scan = [], layers.scan_layers

    def recording(body, carry, lp, **kw):
        def rec_body(c, p):
            with DotRecorder() as r:
                out = body(c, p)
            per_layer.append(r.ops)
            return out
        return scan(rec_body, carry, lp, **{**kw, "remat": False})

    with monkeypatch.context() as m:
        m.setattr(layers, "scan_layers", recording)
        loss_fn(params, *args)
    return per_layer


def test_dots_keeps_exactly_the_layer_products(monkeypatch):
    """Under "dots" the policy marks MUST_SAVE exactly the matrix products
    each layer's body runs (the projections, the adaLN and MLP products,
    and on the CPU the plain K7's), layer by layer, and recomputes every
    other op."""
    from torch.utils.checkpoint import CheckpointPolicy
    loss_fn, params, args, n_layers = case("dit-dots")
    decisions = []
    policy = layers._dots_policy

    def spy(ctx, op, *a, **kw):
        got = policy(ctx, op, *a, **kw)
        decisions.append((ctx.is_recompute, got, op_key(op, a)))
        return got

    with monkeypatch.context() as m:
        m.setattr(layers, "_dots_policy", spy)
        tree.value_and_grad(loss_fn, params, *args)

    per_layer = layer_products(loss_fn, params, args, monkeypatch)
    assert len(per_layer) == n_layers and all(per_layer)
    want = [op for ops in per_layer for op in ops]
    fwd = [d for d in decisions if not d[0]]
    saved = [key for _, got, key in fwd if got == CheckpointPolicy.MUST_SAVE]
    assert saved == want
    assert all(got == CheckpointPolicy.PREFER_RECOMPUTE
               for _, got, key in fwd if key[0].split(".")[1] not in
               ("mm", "addmm", "bmm", "baddbmm"))


@pytest.mark.parametrize("family", ("dit-dots", "dit-nothing"))
def test_backward_reruns_the_products_only_under_nothing(family,
                                                        monkeypatch):
    """Under "dots" the backward dispatches exactly the plain loop's
    products (none is recomputed); under "nothing" it dispatches those and
    every product of every layer's forward again."""
    loss_fn, params, args, _ = case(family)
    remat = collections.Counter(products_in_backward(loss_fn, params, args))
    fwd = collections.Counter(op for ops in layer_products(
        loss_fn, params, args, monkeypatch) for op in ops)
    plain_loop(monkeypatch)
    plain = collections.Counter(products_in_backward(loss_fn, params, args))
    assert fwd and plain
    assert remat == (plain if family == "dit-dots" else plain + fwd)


@pytest.mark.parametrize("family", ATTENTION)
def test_attention_forward_runs_again_in_the_backward(family, monkeypatch):
    """K7's forward (its plain version here, as the kernel's launches on
    the card) runs twice a layer in a remat train step, the forward and
    its recompute, and K7b once; once and once without remat."""
    loss_fn, params, args, n_layers = case(family)
    for remat, want in ((True, 2), (False, 1)):
        with monkeypatch.context() as m:
            if not remat:
                plain_loop(m)
            fwd = count_calls(m, k7, "flash_attention_plain")
            bwd = count_calls(m, k7, "flash_attention_bwd_plain")
            tree.value_and_grad(loss_fn, params, *args)
        assert len(fwd) == want * n_layers
        assert all(kw.get("return_lse") for kw in fwd)
        assert len(bwd) == n_layers


def serve(path: str):
    """One serving call of ``path`` at SMOKE size on the CPU."""
    g = torch.Generator().manual_seed(0)
    if path == "lm-forward" or path == "lm-prefill":
        cfg = configs.get("granite-moe-3b-a800m").smoke
        params = transformer.init_params(cfg, g, "cpu")
        tokens = torch.randint(0, cfg.vocab, (2, 8), generator=g)
        if path == "lm-forward":
            return transformer.forward(params, tokens, cfg)
        return transformer.make_prefill_step(cfg, 16)(params, tokens)
    if path == "vit":
        cfg = configs.get("vit-h14").smoke
        return vit.forward(vit.init_params(cfg, g, "cpu"),
                           torch.rand((1, cfg.img_res, cfg.img_res, 3)), cfg)
    if path == "dit-sample":
        cfg = configs.get("dit-xl2").smoke
        cfg = dataclasses.replace(cfg, remat_policy="dots")
        r = cfg.latent_res()
        t = torch.tensor([500])
        return dit.make_sample_step(cfg)(
            dit.init_params(cfg, g, "cpu"), torch.randn((1, r, r, 4)), t,
            t - 100, torch.tensor([3]))
    if path == "convnext":
        cfg = configs.get("convnext-b").smoke
        return convnext.forward(convnext.init_params(cfg, g, "cpu"),
                                torch.rand((1, 32, 32, 3)), cfg)
    cfg = configs.get("efficientnet-b7").smoke
    params, state = efficientnet.init_params(cfg, g, "cpu")
    return efficientnet.apply(params, state, torch.rand((1, 32, 32, 3)), cfg,
                              train=False)


@pytest.mark.parametrize("path", ("lm-forward", "lm-prefill", "vit",
                                  "dit-sample", "convnext", "efficientnet"))
def test_serving_takes_no_checkpoint(path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a serving forward went through checkpoint")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", refuse)
    out = serve(path)
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first.float()).all()


def test_dots_without_selective_checkpoint_raises(monkeypatch):
    """A torch without selective checkpointing cannot run "dots": the
    train step raises rather than recompute every product ("nothing")."""
    loss_fn, params, args, _ = case("dit-dots")
    monkeypatch.delattr(torch.utils.checkpoint,
                        "create_selective_checkpoint_contexts")
    with pytest.raises(RuntimeError, match="create_selective_checkpoint"):
        tree.value_and_grad(loss_fn, params, *args)
    with pytest.raises(KeyError):
        layers.scan_layers(lambda c, p: (c, None), torch.zeros(1),
                           {"w": torch.zeros(1)}, n_layers=1,
                           remat_policy="everything")
