"""Vision Transformer (ViT-L/16, ViT-H/14): an encoder-only classifier, on
one device or on a mesh.

Counterpart of ``repro.models.vit``.  The assigned shapes run at 224
(cls_224, serve_b1, serve_b128) and 384 (cls_384: the learned position
table is resized bilinearly, the finetune recipe of the ViT paper §3.2).
Parameters are stacked on a leading layer dim as in the reference and the
layers run as a Python loop over them (``layers.scan_layers``), each
checkpointed under autograd with the reference's default policy,
"nothing".  Attention goes through K7
(``layers.chunked_attention``, one q chunk and one key chunk of the whole
sequence, as the reference's) and, under autograd, K7b; the projections,
the MLP and the head are plain matmuls, and the patch embedding a strided
convolution, as the reference leaves them to XLA.

On a mesh (``rules``, the reference's ``param_specs``, written out by
``models.zoo_mesh.Layout``): the batch over the batch axes, the layers'
leaves gathered over ``fsdp`` a layer at a time; QKV column-parallel over
``model`` (``wqkv``'s columns are cut in one block of 3·D, so each rank
gathers them and takes its own heads' q, k and v columns: the gather's
backward reduce-scatters), K7 on each rank's H/tp heads, ``wo`` and
``w2`` row-parallel (``layers.row_parallel``), ``w1`` column-parallel; the
residual stream whole over ``model``.  ``logits``, ``loss_fn`` and
``make_train_step`` take the rank's rows and slices; ``forward`` whole
images, and gives every rank the whole logits.  With ``n_heads`` or
``3·d_model`` not divisible by tp, attention runs whole on every rank.

``binary_dense=True`` runs the QKV, output and MLP projections as STE-sign
binary matmuls on latent float weights (``core.binarize.ste_sign``), which
``make_train_step`` clips to [-1, 1] after each AdamW step.

Layouts: images NHWC; ``patch_w`` is stored (O, I, KH, KW), PyTorch's
conv layout (the reference's HWIO crosses through
:func:`params_from_numpy`).  ``forward`` serves under
``torch.inference_mode``; ``logits`` is the same function under autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import ste_sign
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.models import layers
from repro_torch.models.zoo_mesh import Layout, conv_spec, shard_params
from repro_torch.optim import adamw_update
from repro_torch.tree import value_and_grad


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    pos_grid: int = 0          # side of the *trained* position grid
    binary_dense: bool = False  # PhoneBit technique on QKV/MLP projections
    # the reference's dry-run knob, kept so configs read alike (ViT's remat
    # does not depend on it, as in the reference)
    unroll: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    def n_tokens(self, img_res: int | None = None) -> int:
        r = img_res or self.img_res
        return (r // self.patch) ** 2 + 1

    def param_count(self) -> int:
        d, l = self.d_model, self.n_layers
        per_layer = 4 * d * d + 2 * d * self.d_ff + 4 * d + d + self.d_ff
        patch = self.patch * self.patch * 3 * d + d
        grid = (self.pos_grid or self.img_res // self.patch) ** 2 + 1
        return (l * per_layer + patch + grid * d + d
                + 2 * d + d * self.n_classes + self.n_classes)


#: Leaves stored (O, I, KH, KW); the reference keeps them HWIO.
CONV_LEAVES = frozenset({"patch_w"})
#: Leaves the forward reads in float32 (the norms, and the position table,
#: resized in float32 before its cast): kept float32 whatever ``dtype``.
FLOAT32_LEAVES = frozenset({"ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln_f_s",
                            "ln_f_b", "pos"})
# The projections binary_dense binarises, and whose latent weights the
# train step clips (the reference's path substrings).
_BINARY = ("wqkv", "wo", "w1", "w2")


@torch.no_grad()
def init_params(cfg: ViTConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Parameters with the reference's shapes and scales (projections
    N(0, 1/fan_in) stacked by layer, the patch kernel He-normal, the class
    token, position table and head N(0, 0.02²), biases 0, norm scales 1),
    drawn in float32 from ``generator`` on ``device``; stored in ``dtype``
    (float32 masters to train, bf16 to serve) but for
    ``FLOAT32_LEAVES``."""
    device = resolve_device(device)
    d, l, ff, p = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.patch
    grid = cfg.pos_grid or cfg.img_res // cfg.patch

    def draw(shape, std):
        return layers.draw(shape, std, generator, device)

    def stack(shape):
        return draw((l, *shape), 1.0 / math.sqrt(shape[0]))

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    lay = {
        "ln1_s": ones(l, d), "ln1_b": zeros(l, d),
        "wqkv": stack((d, 3 * d)), "bqkv": zeros(l, 3 * d),
        "wo": stack((d, d)), "bo": zeros(l, d),
        "ln2_s": ones(l, d), "ln2_b": zeros(l, d),
        "w1": stack((d, ff)), "b1": zeros(l, ff),
        "w2": stack((ff, d)), "b2": zeros(l, d),
    }
    params = {
        "patch_w": draw((d, 3, p, p), math.sqrt(2.0 / (p * p * 3))),
        "patch_b": zeros(d),
        "cls": draw((1, 1, d), 0.02),
        "pos": draw((grid * grid + 1, d), 0.02),
        "layers": lay,
        "ln_f_s": ones(d), "ln_f_b": zeros(d),
        "head_w": draw((d, cfg.n_classes), 0.02),
        "head_b": zeros(cfg.n_classes),
    }
    return layers.store(params, dtype, FLOAT32_LEAVES)


def param_specs(cfg: ViTConfig, rules) -> dict:
    """The reference's spec tree (FSDP over ``rules.fsdp``, heads and
    ``d_ff`` over ``rules.model``), ``patch_w``'s in its (O, I, KH, KW)
    layout."""
    fs, mp = rules.fsdp, rules.model
    ff = rules.shard_if(cfg.d_ff, mp)
    d3 = rules.shard_if(3 * cfg.d_model, mp)
    lay = {
        "ln1_s": P(None, None), "ln1_b": P(None, None),
        "wqkv": P(None, fs, d3), "bqkv": P(None, d3),
        "wo": P(None, rules.shard_if(cfg.d_model, mp), fs),
        "bo": P(None, None),
        "ln2_s": P(None, None), "ln2_b": P(None, None),
        "w1": P(None, fs, ff), "b1": P(None, ff),
        "w2": P(None, ff, fs), "b2": P(None, None),
    }
    return {
        "patch_w": conv_spec(P(None, None, None,
                               rules.shard_if(cfg.d_model, mp))),
        "patch_b": P(None),
        "cls": P(None, None, None),
        "pos": P(None, None),
        "layers": lay,
        "ln_f_s": P(None), "ln_f_b": P(None),
        "head_w": P(fs, None), "head_b": P(None),
    }


def abstract_params(cfg: ViTConfig, dtype: torch.dtype = torch.float32
                    ) -> dict:
    """``init_params``' tree of full shapes and dtypes as meta tensors (no
    memory)."""
    return init_params(cfg, None, "meta", dtype)


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ViTConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32,
                      rules=None) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree as
    numpy arrays: the same values, ``patch_w`` in (O, I, KH, KW), stored as
    :func:`init_params` stores them; with ``rules`` this rank's slices of
    :func:`param_specs`."""
    full = layers.tree_from_numpy(tree, resolve_device(device), dtype,
                                  CONV_LEAVES, FLOAT32_LEAVES)
    return shard_params(full, rules and param_specs(cfg, rules), rules)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _maybe_binary(w: torch.Tensor, x: torch.Tensor, enabled: bool,
                  row=None) -> torch.Tensor:
    """Dense matmul, optionally in the binary (±1 STE) domain; ``row``:
    the product as a row-parallel one (``Layout.row``)."""
    cd = layers.COMPUTE_DTYPE
    if enabled:
        x, w = ste_sign(x.float()).to(cd), ste_sign(w)
    if row is not None:
        return row(x, w)
    return x @ w.to(cd)


def resize_pos_embed(pos: torch.Tensor, grid_from: int,
                     grid_to: int) -> torch.Tensor:
    """Bilinear resize of the (G²+1, D) position table (finetune at 384);
    the class token's row stays."""
    if grid_from == grid_to:
        return pos
    d = pos.shape[-1]
    img = pos[1:].reshape(1, grid_from, grid_from, d)
    img = layers.resize_grid(img, grid_to, grid_to)
    return torch.cat([pos[:1], img.reshape(grid_to * grid_to, d)], dim=0)


class _Plan:
    """How one rank runs a layer under ``rules``: which products are cut
    over ``model``, and each layer's leaves as the rank uses them."""

    def __init__(self, cfg: ViTConfig, rules):
        self.cfg, self.lay = cfg, Layout(rules)
        self.specs = param_specs(cfg, rules) if rules is not None else None
        tp, lay_specs = self.lay.tp, self.specs and self.specs["layers"]
        cut = (lambda name, dim: tp > 1
               and lay_specs[name][dim] is not None)
        self.qkv_cols = cut("wqkv", 2)
        self.tp_heads = self.qkv_cols and cfg.n_heads % tp == 0
        self.wo_rows = cut("wo", 1)
        self.ff_cols = cut("w1", 2)

    def layer(self, lp: dict) -> dict:
        """The layer's leaves whole over ``fsdp``; ``wqkv`` / ``bqkv`` the
        rank's heads' q, k and v columns (gathered over ``model``, the
        backward reduce-scattering the cotangent), or whole where
        attention runs whole."""
        lay = self.lay
        if not lay.on:
            return lp
        lp = lay.layer(lp, self.specs["layers"])
        if self.tp_heads:
            w, b = sharding.gather_fsdp([lp["wqkv"], lp["bqkv"]], [-1, -1],
                                        lay.model)
            i, n = lay.model.index, self.cfg.d_model // lay.tp
            lp["wqkv"] = w.unflatten(-1, (3, lay.tp, n))[..., i, :].flatten(
                -2)
            lp["bqkv"] = b.unflatten(-1, (3, lay.tp, n))[..., i, :].flatten(
                -2)
        elif self.qkv_cols:
            m = lay.rules.model
            lp["wqkv"], lp["bqkv"] = lay.whole(
                [lp["wqkv"], lp["bqkv"]], [P(None, m), P(m)])
        return lp

    def col_in(self, h: torch.Tensor, cut: bool) -> torch.Tensor:
        return self.lay.col_in(h) if cut else h

    def row(self, cut: bool):
        return self.lay.row if cut else None


def logits(params: dict, images: torch.Tensor, cfg: ViTConfig,
           rules=None) -> torch.Tensor:
    """images (B, R, R, 3) float -> logits (B, n_classes) in bf16, under
    autograd (each layer checkpointed).  With ``rules``: this rank's
    slices and rows, its rows' logits."""
    plan = _Plan(cfg, rules)
    lay = plan.lay
    b, r = images.shape[:2]
    cd = layers.COMPUTE_DTYPE
    g = r // cfg.patch
    patch_w = params["patch_w"]
    if lay.on:
        (patch_w,) = lay.whole([patch_w], [plan.specs["patch_w"]])
    x = F.conv2d(images.to(cd).permute(0, 3, 1, 2), patch_w.to(cd),
                 stride=cfg.patch)
    x = x.permute(0, 2, 3, 1).reshape(b, g * g, cfg.d_model)
    x = x + params["patch_b"].to(cd)
    cls = params["cls"].to(cd).expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    grid_from = cfg.pos_grid or cfg.img_res // cfg.patch
    pos = resize_pos_embed(params["pos"], grid_from, g)
    x = x + pos.to(cd)[None]

    hd, s, bd = cfg.d_head, x.shape[1], cfg.binary_dense

    def layer_body(x, lp):
        lp = plan.layer(lp)
        hn = layers.layer_norm(x, lp["ln1_s"], lp["ln1_b"])
        qkv = (_maybe_binary(lp["wqkv"], plan.col_in(hn, plan.tp_heads), bd)
               + lp["bqkv"].to(cd))
        w = qkv.shape[-1] // 3                   # this rank's heads' width
        q, k, v = (t.reshape(b, s, w // hd, hd).contiguous()
                   for t in qkv.split(w, dim=-1))
        o = layers.chunked_attention(q, k, v, causal=False, q_chunk=s,
                                     kv_chunk=s).reshape(b, s, w)
        if plan.wo_rows and not plan.tp_heads:
            o = lay.part(o)
        o = (_maybe_binary(lp["wo"], o, bd, plan.row(plan.wo_rows))
             + lp["bo"].to(cd))
        x = x + o
        hn = layers.layer_norm(x, lp["ln2_s"], lp["ln2_b"])
        hmid = layers.gelu(
            _maybe_binary(lp["w1"], plan.col_in(hn, plan.ff_cols), bd)
            + lp["b1"].to(cd), exact=bd)
        return x + (_maybe_binary(lp["w2"], hmid, bd, plan.row(plan.ff_cols))
                    + lp["b2"].to(cd)), None

    x, _ = layers.scan_layers(layer_body, x, params["layers"],
                              n_layers=cfg.n_layers)
    x = layers.layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    head_w = params["head_w"]
    if lay.on:
        (head_w,) = lay.fsdp([head_w], [plan.specs["head_w"]])
    return x[:, 0, :] @ head_w.to(cd) + params["head_b"].to(cd)


@torch.inference_mode()
def forward(params: dict, images: torch.Tensor, cfg: ViTConfig,
            rules=None) -> torch.Tensor:
    """Serving: images (B, R, R, 3) float -> logits (B, n_classes), bf16.
    With ``rules``, on every rank: the whole images in (each rank runs
    its rows), the whole logits out."""
    lay = Layout(rules)
    out = logits(params, lay.rows(images), cfg, rules)
    return lay.gather_rows(out, images.shape[0])


def loss_fn(params: dict, batch: dict, cfg: ViTConfig, rules=None):
    """(mean cross entropy of ``batch["images"]`` against
    ``batch["labels"]``, {}).  With ``rules``: the rank's rows of the
    batch (``rules.batch_cut``); the loss is the global mean, the same on
    every rank."""
    lg = logits(params, batch["images"], cfg, rules).float()
    gold = torch.take_along_dim(lg, batch["labels"].long()[:, None],
                                dim=-1)[:, 0]
    ce = torch.logsumexp(lg, dim=-1) - gold
    if rules is None:
        return ce.mean(), {}
    return Layout(rules).mean_over_batch(ce.sum(), ce.shape[0]), {}


def make_train_step(cfg: ViTConfig, rules=None, *, lr=1e-3) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss's gradient (attention's through K7b), then one AdamW step with the
    reference's defaults; with ``binary_dense`` the binarised projections'
    latent weights are clipped to [-1, 1].  With ``rules`` (every rank
    calls it on its slices and rows; the optimiser state mirrors the
    slices): the gradient summed over the batch axes a leaf is replicated
    over, clipped by the global norm over every rank's leaves."""
    clip = ((lambda path: any(n in path for n in _BINARY))
            if cfg.binary_dense else None)
    specs = param_specs(cfg, rules) if rules is not None else None
    lay = Layout(rules)

    def train_step(params, opt_state, batch):
        (loss, _), grads = value_and_grad(loss_fn, params, batch, cfg,
                                          rules)
        grads = lay.sync(grads, specs)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             lr=lr, clip_latent_paths=clip,
                                             rules=rules, specs=specs)
        return params, opt_state, {"loss": loss, **om}

    return train_step
