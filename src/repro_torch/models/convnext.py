"""ConvNeXt-B (Liu et al., arXiv:2201.03545), on one device or on a
mesh.

Counterpart of ``repro.models.convnext``: depths (3, 3, 27, 3), dims (128,
256, 512, 1024).  A block is a 7×7 depthwise conv, LN, a 1×1 expand (4×,
GELU), a 1×1 project and a layer scale on the residual; stages are
separated by LN and a 2×2 stride-2 conv.  The blocks of a stage are
stacked on a leading dim as in the reference (its ``scan``) and run as a
Python loop (``layers.scan_layers``), each checkpointed under autograd
with the "nothing" policy unless ``cfg.unroll``, as the reference's
``nothing_saveable``.  No Pallas kernel runs here in the reference, which
leaves every conv to XLA: the stem, downsample and depthwise convs are
``F.conv2d`` and the 1×1 convs matmuls over the channels.

``binary_pointwise=True`` runs the 1×1 expand/project as STE-sign binary
matmuls on latent float weights, which ``make_train_step`` clips to
[-1, 1]; the depthwise convs stay float.  Layouts: images and activations
NHWC (channels-last inside the convs); conv kernels stored (O, I, KH, KW)
(a depthwise (7, 7, 1, C) as (C, 1, 7, 7)), the 1×1 weights (I, O) as the
reference keeps them.  The head takes a float32 mean and runs in float32,
as the reference's.  ``forward`` serves under ``torch.inference_mode``;
``logits`` is the same function under autograd.

On a mesh (``rules``: the reference's ``param_specs``, their collectives
written out through ``models.zoo_mesh.Layout``): the batch over the batch
axes and ``w1``, ``w2`` and the head gathered over ``fsdp``.  The layout
over ``model`` is the port's choice: the residual stream keeps its
channels whole on every model rank (the reference keeps them cut over
``model`` between stages, ``convnext.py:187``), and each block's 1×1 pair
is Megatron's column-then-row split: ``w1``'s 4·dim outputs cut over
``model`` (its bias's block taken from the whole one), ``w2``
row-parallel (``layers.row_parallel``: one sum over ``model`` a block,
float32 partials rounded once).  So the LayerNorms over channels, the
depthwise convolutions and the head's spatial mean run whole, as on one
device, and need no sum over ``model``; the stem, downsample and
depthwise kernels, whose output channels the specs cut over ``model``,
are gathered for it (their gradient each rank's own block).  The math is
the one-device math.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import ste_sign
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P
from repro_torch.models import layers
from repro_torch.models.zoo_mesh import Layout, conv_spec, shard_params
from repro_torch.optim import adamw_update
from repro_torch.tree import value_and_grad


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    name: str
    img_res: int = 224
    depths: tuple[int, ...] = (3, 3, 27, 3)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    n_classes: int = 1000
    layer_scale_init: float = 1e-6
    binary_pointwise: bool = False
    # the reference's dry-run knob: the blocks run without remat under it
    unroll: bool = False

    def param_count(self) -> int:
        total = 4 * 4 * 3 * self.dims[0] + self.dims[0] * 2
        prev = self.dims[0]
        for depth, dim in zip(self.depths, self.dims):
            if dim != prev:
                total += prev * dim * 4 + dim + prev * 2
            total += depth * (7 * 7 * dim + dim * 2 + dim * 4 * dim
                              + 4 * dim + 4 * dim * dim + dim + dim)
            prev = dim
        return total + self.dims[-1] * 2 + self.dims[-1] * self.n_classes


#: Leaves stored (O, I, KH, KW); the reference keeps them HWIO.
CONV_LEAVES = frozenset({"stem_w", "down_w", "dw_w"})
#: Leaves the forward reads in float32 (every LN and the float32 head):
#: kept float32 whatever ``dtype``.
FLOAT32_LEAVES = frozenset({"stem_ln_s", "stem_ln_b", "down_ln_s",
                            "down_ln_b", "ln_s", "ln_b", "head_ln_s",
                            "head_ln_b", "head_w", "head_b"})


@torch.no_grad()
def init_params(cfg: ConvNeXtConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Parameters with the reference's shapes and scales (convs He-normal,
    1×1 weights N(0, 1/fan_in), the head N(0, 0.02²), biases 0, LN scales
    1, the layer scale ``layer_scale_init``), drawn in float32 from
    ``generator`` on ``device``; stored in ``dtype`` but for
    ``FLOAT32_LEAVES``."""
    device = resolve_device(device)

    def draw(shape, std):
        return layers.draw(shape, std, generator, device)

    def conv(*shape):            # (..., O, I, KH, KW), He-normal
        return draw(shape, math.sqrt(2.0 / math.prod(shape[-3:])))

    def fanin(*shape):           # (..., I, O)
        return draw(shape, 1.0 / math.sqrt(shape[-2]))

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    d0 = cfg.dims[0]
    params: dict = {"stem_w": conv(d0, 3, 4, 4), "stem_b": zeros(d0),
                    "stem_ln_s": ones(d0), "stem_ln_b": zeros(d0),
                    "stages": []}
    prev = d0
    for depth, dim in zip(cfg.depths, cfg.dims):
        stage: dict = {}
        if dim != prev:
            stage.update(down_ln_s=ones(prev), down_ln_b=zeros(prev),
                         down_w=conv(dim, prev, 2, 2), down_b=zeros(dim))
        stage["blocks"] = {
            "dw_w": conv(depth, dim, 1, 7, 7), "dw_b": zeros(depth, dim),
            "ln_s": ones(depth, dim), "ln_b": zeros(depth, dim),
            "w1": fanin(depth, dim, 4 * dim), "b1": zeros(depth, 4 * dim),
            "w2": fanin(depth, 4 * dim, dim), "b2": zeros(depth, dim),
            "gamma": torch.full((depth, dim), cfg.layer_scale_init,
                                device=device),
        }
        params["stages"].append(stage)
        prev = dim
    params.update(head_ln_s=ones(cfg.dims[-1]), head_ln_b=zeros(cfg.dims[-1]),
                  head_w=draw((cfg.dims[-1], cfg.n_classes), 0.02),
                  head_b=zeros(cfg.n_classes))
    return layers.store(params, dtype, FLOAT32_LEAVES)


def param_specs(cfg: ConvNeXtConfig, rules) -> dict:
    """The reference's spec tree (channels over ``rules.model``, the 1×1
    pair and the head over ``rules.fsdp``), the conv kernels' in their
    (O, I, KH, KW) layout."""
    fs, mp = rules.fsdp, rules.model
    specs: dict = {
        "stem_w": conv_spec(P(None, None, None,
                              rules.shard_if(cfg.dims[0], mp))),
        "stem_b": P(None), "stem_ln_s": P(None), "stem_ln_b": P(None),
        "stages": [],
    }
    prev = cfg.dims[0]
    for dim in cfg.dims:
        st: dict = {}
        if dim != prev:
            st["down_ln_s"] = P(None)
            st["down_ln_b"] = P(None)
            st["down_w"] = conv_spec(P(None, None, None,
                                       rules.shard_if(dim, mp)))
            st["down_b"] = P(None)
        st["blocks"] = {
            "dw_w": conv_spec(P(None, None, None, None,
                                rules.shard_if(dim, mp))),
            "dw_b": P(None, None),
            "ln_s": P(None, None), "ln_b": P(None, None),
            "w1": P(None, fs, rules.shard_if(4 * dim, mp)),
            "b1": P(None, None),
            "w2": P(None, rules.shard_if(4 * dim, mp), fs),
            "b2": P(None, None),
            "gamma": P(None, None),
        }
        specs["stages"].append(st)
        prev = dim
    specs.update({
        "head_ln_s": P(None), "head_ln_b": P(None),
        "head_w": P(fs, None), "head_b": P(None),
    })
    return specs


def abstract_params(cfg: ConvNeXtConfig,
                    dtype: torch.dtype = torch.float32) -> dict:
    """``init_params``' tree of full shapes and dtypes as meta tensors (no
    memory)."""
    return init_params(cfg, None, "meta", dtype)


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ConvNeXtConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32,
                      rules=None) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree as
    numpy arrays: the same values, conv kernels in (O, I, KH, KW), stored
    as :func:`init_params` stores them; with ``rules`` this rank's slices
    of :func:`param_specs`."""
    full = layers.tree_from_numpy(tree, resolve_device(device), dtype,
                                  CONV_LEAVES, FLOAT32_LEAVES)
    return shard_params(full, rules and param_specs(cfg, rules), rules)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: int = 0, groups: int = 1) -> torch.Tensor:
    """An NHWC conv in ``x``'s dtype, through a channels-last view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def _pointwise(x: torch.Tensor, w: torch.Tensor, binary: bool,
               row=None) -> torch.Tensor:
    """A 1×1 conv over the channels, optionally binary (±1 STE); ``row``:
    as a row-parallel product (``Layout.row``)."""
    cd = layers.COMPUTE_DTYPE
    if binary:
        x, w = ste_sign(x.float()).to(cd), ste_sign(w)
    if row is not None:
        return row(x, w)
    return x @ w.to(cd)


def logits(params: dict, images: torch.Tensor, cfg: ConvNeXtConfig,
           rules=None) -> torch.Tensor:
    """images (B, R, R, 3) float -> logits (B, n_classes) in float32,
    under autograd (each block checkpointed unless ``cfg.unroll``).  With
    ``rules``: this rank's slices and rows, its rows' logits."""
    lay = Layout(rules)
    specs = param_specs(cfg, rules) if lay.on else None
    cut = lay.on and lay.tp > 1
    cd = layers.COMPUTE_DTYPE
    stem_w = params["stem_w"]
    if lay.on:
        (stem_w,) = lay.whole([stem_w], [specs["stem_w"]])
    x = _conv(images.to(cd), stem_w, stride=4)
    x = x + params["stem_b"].to(cd)
    x = layers.layer_norm(x, params["stem_ln_s"], params["stem_ln_b"])
    prev = cfg.dims[0]
    for i, (stage, depth, dim) in enumerate(zip(params["stages"],
                                                cfg.depths, cfg.dims)):
        bspecs = specs and specs["stages"][i]["blocks"]
        if dim != prev:
            down_w = stage["down_w"]
            if lay.on:
                (down_w,) = lay.whole([down_w],
                                      [specs["stages"][i]["down_w"]])
            x = layers.layer_norm(x, stage["down_ln_s"], stage["down_ln_b"])
            x = _conv(x, down_w, stride=2) + stage["down_b"].to(cd)
        ff_cols = cut and bspecs["w1"][2] is not None

        # ``dim`` is bound now: the backward's recompute calls the block
        # after the loop has moved on.
        def block(x, bp, dim=dim, bspecs=bspecs, ff_cols=ff_cols):
            if lay.on:
                bp = lay.layer(bp, bspecs)
                (bp["dw_w"],) = lay.whole(
                    [bp["dw_w"]], [P(*list(bspecs["dw_w"])[1:])])
            h = _conv(x, bp["dw_w"], padding=3, groups=dim)
            h = h + bp["dw_b"].to(cd)
            h = layers.layer_norm(h, bp["ln_s"], bp["ln_b"])
            if ff_cols:
                h, b1 = lay.col_in(h), lay.part(bp["b1"])
            else:
                b1 = bp["b1"]
            h = layers.gelu(_pointwise(h, bp["w1"], cfg.binary_pointwise)
                            + b1.to(cd), exact=cfg.binary_pointwise)
            h = (_pointwise(h, bp["w2"], cfg.binary_pointwise,
                            lay.row if ff_cols else None)
                 + bp["b2"].to(cd))
            return x + bp["gamma"].to(cd) * h, None

        x, _ = layers.scan_layers(block, x, stage["blocks"], n_layers=depth,
                                  remat=not cfg.unroll)
        prev = dim
    x = x.float().mean(dim=(1, 2))
    x = layers.layer_norm(x, params["head_ln_s"], params["head_ln_b"])
    head_w = params["head_w"]
    if lay.on:
        (head_w,) = lay.fsdp([head_w], [specs["head_w"]])
    return x @ head_w.float() + params["head_b"].float()


@torch.inference_mode()
def forward(params: dict, images: torch.Tensor, cfg: ConvNeXtConfig,
            rules=None) -> torch.Tensor:
    """Serving: images (B, R, R, 3) float -> logits (B, n_classes),
    float32.  With ``rules``, on every rank: the whole images in (each
    rank runs its rows), the whole logits out."""
    lay = Layout(rules)
    out = logits(params, lay.rows(images), cfg, rules)
    return lay.gather_rows(out, images.shape[0])


def loss_fn(params: dict, batch: dict, cfg: ConvNeXtConfig, rules=None):
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


def make_train_step(cfg: ConvNeXtConfig, rules=None, *, lr=4e-3
                    ) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    AdamW step with the reference's defaults; with ``binary_pointwise`` the
    blocks' 1×1 latent weights are clipped to [-1, 1].  With ``rules``: as
    ``vit.make_train_step``'s."""
    clip = ((lambda p: ("w1" in p or "w2" in p) and "blocks" in p)
            if cfg.binary_pointwise else None)
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
