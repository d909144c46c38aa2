"""Vision Transformer (ViT-L/16, ViT-H/14): an encoder-only classifier on
one device.

Counterpart of ``repro.models.vit``.  The assigned shapes run at 224
(cls_224, serve_b1, serve_b128) and 384 (cls_384: the learned position
table is resized bilinearly, the finetune recipe of the ViT paper §3.2).
Parameters are stacked on a leading layer dim as in the reference and the
layers run as a Python loop over them (``layers.scan_layers``), each
checkpointed under autograd with the reference's default policy,
"nothing"; one card has nothing to shard, so the reference's ``rules``
argument is gone.  Attention goes through K7
(``layers.chunked_attention``, one q chunk and one key chunk of the whole
sequence, as the reference's) and, under autograd, K7b; the projections,
the MLP and the head are plain matmuls, and the patch embedding a strided
convolution, as the reference leaves them to XLA.

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
from repro_torch.models import layers
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


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ViTConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree as
    numpy arrays: the same values, ``patch_w`` in (O, I, KH, KW), stored as
    :func:`init_params` stores them."""
    del cfg
    return layers.tree_from_numpy(tree, resolve_device(device), dtype,
                                  CONV_LEAVES, FLOAT32_LEAVES)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _maybe_binary(w: torch.Tensor, x: torch.Tensor,
                  enabled: bool) -> torch.Tensor:
    """Dense matmul, optionally in the binary (±1 STE) domain."""
    cd = layers.COMPUTE_DTYPE
    if not enabled:
        return x @ w.to(cd)
    return ste_sign(x.float()).to(cd) @ ste_sign(w).to(cd)


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


def logits(params: dict, images: torch.Tensor, cfg: ViTConfig
           ) -> torch.Tensor:
    """images (B, R, R, 3) float -> logits (B, n_classes) in bf16, under
    autograd (each layer checkpointed)."""
    b, r = images.shape[:2]
    cd = layers.COMPUTE_DTYPE
    g = r // cfg.patch
    x = F.conv2d(images.to(cd).permute(0, 3, 1, 2), params["patch_w"].to(cd),
                 stride=cfg.patch)
    x = x.permute(0, 2, 3, 1).reshape(b, g * g, cfg.d_model)
    x = x + params["patch_b"].to(cd)
    cls = params["cls"].to(cd).expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    grid_from = cfg.pos_grid or cfg.img_res // cfg.patch
    pos = resize_pos_embed(params["pos"], grid_from, g)
    x = x + pos.to(cd)[None]

    h, hd, s, d = cfg.n_heads, cfg.d_head, x.shape[1], cfg.d_model

    def layer_body(x, lp):
        hn = layers.layer_norm(x, lp["ln1_s"], lp["ln1_b"])
        qkv = (_maybe_binary(lp["wqkv"], hn, cfg.binary_dense)
               + lp["bqkv"].to(cd))
        q, k, v = (t.reshape(b, s, h, hd).contiguous()
                   for t in qkv.split(d, dim=-1))
        o = layers.chunked_attention(q, k, v, causal=False, q_chunk=s,
                                     kv_chunk=s)
        o = (_maybe_binary(lp["wo"], o.reshape(b, s, d), cfg.binary_dense)
             + lp["bo"].to(cd))
        x = x + o
        hn = layers.layer_norm(x, lp["ln2_s"], lp["ln2_b"])
        hmid = layers.gelu(_maybe_binary(lp["w1"], hn, cfg.binary_dense)
                           + lp["b1"].to(cd), exact=cfg.binary_dense)
        return x + (_maybe_binary(lp["w2"], hmid, cfg.binary_dense)
                    + lp["b2"].to(cd)), None

    x, _ = layers.scan_layers(layer_body, x, params["layers"],
                              n_layers=cfg.n_layers)
    x = layers.layer_norm(x, params["ln_f_s"], params["ln_f_b"])
    return x[:, 0, :] @ params["head_w"].to(cd) + params["head_b"].to(cd)


@torch.inference_mode()
def forward(params: dict, images: torch.Tensor, cfg: ViTConfig
            ) -> torch.Tensor:
    """Serving: images (B, R, R, 3) float -> logits (B, n_classes), bf16."""
    return logits(params, images, cfg)


def loss_fn(params: dict, batch: dict, cfg: ViTConfig):
    """(mean cross entropy of ``batch["images"]`` against
    ``batch["labels"]``, {})."""
    lg = logits(params, batch["images"], cfg).float()
    gold = torch.take_along_dim(lg, batch["labels"].long()[:, None],
                                dim=-1)[:, 0]
    return (torch.logsumexp(lg, dim=-1) - gold).mean(), {}


def make_train_step(cfg: ViTConfig, *, lr=1e-3) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss's gradient (attention's through K7b), then one AdamW step with the
    reference's defaults; with ``binary_dense`` the binarised projections'
    latent weights are clipped to [-1, 1]."""
    clip = ((lambda path: any(n in path for n in _BINARY))
            if cfg.binary_dense else None)

    def train_step(params, opt_state, batch):
        (loss, _), grads = value_and_grad(loss_fn, params, batch, cfg)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             lr=lr, clip_latent_paths=clip)
        return params, opt_state, {"loss": loss, **om}

    return train_step
