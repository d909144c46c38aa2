"""Diffusion Transformer (DiT-L/2, DiT-XL/2; Peebles & Xie,
arXiv:2212.09748) on one device.

Counterpart of ``repro.models.dit``.  It works in a VAE latent space (8×
downsample, 4 channels): 256² images are 32×32×4 latents, patch 2, 256
tokens.  The timestep and the class enter through adaLN-zero: each block
regresses shift, scale and gate from the conditioning vector, and the
modulation and output weights start at zero, so a fresh model predicts 0.

Steps: ``make_train_step`` (DDPM ε-prediction MSE at the batch's t, AdamW
without weight decay) and ``make_sample_step`` (one deterministic DDIM
update, eta 0; a 50-step sampler is 50 calls).  Parameters are stacked on
a leading layer dim and the layers run as a Python loop over them
(``layers.scan_layers``), each checkpointed under autograd with
``cfg.remat_policy`` ("dots" in both FULL configs: the matrix products'
outputs are kept, the rest recomputed); the reference's ``rules`` and its
``seq_shard``, a multi-chip setting, have no use on one card (the configs
keep the field).  Attention goes through K7
(``layers.chunked_attention``) and, under autograd, K7b; the projections,
the MLP and the conditioning MLP are plain matmuls, as the reference
leaves them to XLA.  The conditioning runs in float32 and is cast to bf16
only after its last SiLU, as the reference's.  ``forward`` serves under
``torch.inference_mode``; ``eps_and_sigma`` is the same function under
autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.optim import adamw_update
from repro_torch.tree import value_and_grad


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    name: str
    img_res: int               # pixel resolution (latent = /8)
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    n_classes: int = 1000
    latent_channels: int = 4
    vae_downsample: int = 8
    mlp_ratio: int = 4
    # diffusion schedule
    n_train_timesteps: int = 1000
    # the reference's dry-run and sharding knobs, kept so configs read
    # alike; one card reads ``remat_policy`` alone
    unroll: bool = False
    remat_policy: str = "nothing"
    seq_shard: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ff(self) -> int:
        return self.mlp_ratio * self.d_model

    def latent_res(self, img_res: int | None = None) -> int:
        return (img_res or self.img_res) // self.vae_downsample

    def n_tokens(self, img_res: int | None = None) -> int:
        return (self.latent_res(img_res) // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.latent_channels

    def param_count(self) -> int:
        d, l = self.d_model, self.n_layers
        per_layer = 4 * d * d + 2 * d * self.d_ff + d * 6 * d + 6 * d
        cond = 256 * d + d * d + self.n_classes * d
        final = d * 2 * d + d * 2 * self.patch_dim
        return (l * per_layer + cond + self.patch_dim * d + final)


#: Leaves the forward reads in float32 (the position table, resized in
#: float32, and the conditioning MLP and label table): kept float32
#: whatever ``dtype``.
FLOAT32_LEAVES = frozenset({"pos", "t_mlp1", "t_mlp2", "label_emb"})


@torch.no_grad()
def init_params(cfg: DiTConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Parameters with the reference's shapes and scales (projections
    N(0, 1/fan_in) stacked by layer, the patch and conditioning matrices
    N(0, 1/fan_in), position and label tables N(0, 0.02²); adaLN-zero: the
    modulation weights and biases and the final projection 0), drawn in
    float32 from ``generator`` on ``device``; stored in ``dtype`` but for
    ``FLOAT32_LEAVES``."""
    device = resolve_device(device)
    d, l, ff, pd = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.patch_dim
    grid = cfg.latent_res() // cfg.patch

    def fanin(*shape):
        return layers.draw(shape, 1.0 / math.sqrt(shape[-2]), generator,
                           device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    lay = {
        "wqkv": fanin(l, d, 3 * d), "wo": fanin(l, d, d),
        "w1": fanin(l, d, ff), "w2": fanin(l, ff, d),
        "ada_w": zeros(l, d, 6 * d), "ada_b": zeros(l, 6 * d),
    }
    params = {
        "patch_w": fanin(pd, d), "patch_b": zeros(d),
        "pos": layers.draw((grid * grid, d), 0.02, generator, device),
        "t_mlp1": fanin(256, d), "t_mlp2": fanin(d, d),
        "label_emb": layers.draw((cfg.n_classes + 1, d), 0.02, generator,
                                 device),
        "layers": lay,
        "final_ada_w": zeros(d, 2 * d), "final_ada_b": zeros(2 * d),
        # 2x channels: (eps, sigma), as the paper predicts
        "final_w": zeros(d, 2 * pd), "final_b": zeros(2 * pd),
    }
    return layers.store(params, dtype, FLOAT32_LEAVES)


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: DiTConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree as
    numpy arrays: the same values and layouts, stored as
    :func:`init_params` stores them."""
    del cfg
    return layers.tree_from_numpy(tree, resolve_device(device), dtype,
                                  keep32=FLOAT32_LEAVES)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal features of diffusion timesteps t (B,) -> (B, dim),
    float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(lat: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/p * W/p, p*p*C)."""
    b, hh, ww, c = lat.shape
    g_h, g_w = hh // patch, ww // patch
    x = lat.reshape(b, g_h, patch, g_w, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g_h * g_w, patch * patch * c)


def unpatchify(x: torch.Tensor, patch: int, grid: int, c: int
               ) -> torch.Tensor:
    """(B, grid², p*p*C) -> (B, grid*p, grid*p, C), the inverse of
    :func:`patchify`."""
    b = x.shape[0]
    x = x.reshape(b, grid, grid, patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid * patch, grid * patch, c)


def eps_and_sigma(params: dict, latents: torch.Tensor, t: torch.Tensor,
                  labels: torch.Tensor, cfg: DiTConfig):
    """latents (B, Hl, Wl, C), t (B,) int, labels (B,) int -> (eps,
    sigma_raw), each (B, Hl, Wl, C) in bf16, under autograd (each layer
    checkpointed under ``cfg.remat_policy``)."""
    b, hl, _, c = latents.shape
    cd = layers.COMPUTE_DTYPE
    grid = hl // cfg.patch
    s = grid * grid
    x = patchify(latents, cfg.patch).to(cd) @ params["patch_w"].to(cd)
    x = x + params["patch_b"].to(cd)
    pos = params["pos"]
    if pos.shape[0] != s:
        side = math.isqrt(pos.shape[0])
        pos = layers.resize_grid(pos.reshape(1, side, side, -1), grid,
                                 grid).reshape(s, -1)
    x = x + pos.to(cd)[None]

    temb = timestep_embedding(t) @ params["t_mlp1"].float()
    cvec = (layers.silu(temb) @ params["t_mlp2"].float()
            + params["label_emb"].float()[labels.long()])     # (B, D) f32
    cvec = layers.silu(cvec).to(cd)

    h, hd, d = cfg.n_heads, cfg.d_head, cfg.d_model

    def layer_body(x, lp):
        mods = cvec @ lp["ada_w"].to(cd) + lp["ada_b"].to(cd)
        sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
        hn = layers.modulate(layers.layer_norm(x, None, None), sh1, sc1)
        qkv = hn @ lp["wqkv"].to(cd)
        q, k, v = (t_.reshape(b, s, h, hd).contiguous()
                   for t_ in qkv.split(d, dim=-1))
        o = layers.chunked_attention(q, k, v, causal=False, q_chunk=s,
                                     kv_chunk=min(1024, s))
        o = o.reshape(b, s, d) @ lp["wo"].to(cd)
        x = x + g1[:, None, :] * o
        hn = layers.modulate(layers.layer_norm(x, None, None), sh2, sc2)
        out = layers.gelu(hn @ lp["w1"].to(cd)) @ lp["w2"].to(cd)
        return x + g2[:, None, :] * out, None

    x, _ = layers.scan_layers(layer_body, x, params["layers"],
                              n_layers=cfg.n_layers,
                              remat_policy=cfg.remat_policy)
    fmods = (cvec @ params["final_ada_w"].to(cd)
             + params["final_ada_b"].to(cd))
    fsh, fsc = fmods.chunk(2, dim=-1)
    x = layers.modulate(layers.layer_norm(x, None, None), fsh, fsc)
    out = x @ params["final_w"].to(cd) + params["final_b"].to(cd)
    eps, sigma = out.chunk(2, dim=-1)
    return (unpatchify(eps, cfg.patch, grid, c),
            unpatchify(sigma, cfg.patch, grid, c))


@torch.inference_mode()
def forward(params: dict, latents: torch.Tensor, t: torch.Tensor,
            labels: torch.Tensor, cfg: DiTConfig):
    """Serving: (eps, sigma_raw), each (B, Hl, Wl, C) in bf16."""
    return eps_and_sigma(params, latents, t, labels, cfg)


# --------------------------------------------------------------------------
# Diffusion schedule (linear betas, DDPM) + steps
# --------------------------------------------------------------------------

def alphas_cumprod(cfg: DiTConfig, device=None) -> torch.Tensor:
    """ᾱ_t of the linear beta schedule 1e-4 .. 0.02, float32."""
    betas = torch.linspace(1e-4, 0.02, cfg.n_train_timesteps,
                           dtype=torch.float32, device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def train_loss(params: dict, batch: dict, cfg: DiTConfig):
    """batch: latents (B, H, W, C), labels (B,), t (B,), noise (B, H, W,
    C).  (MSE of the predicted ε against the noise, {})."""
    t = batch["t"].long()
    acp = alphas_cumprod(cfg, t.device)[t][:, None, None, None]
    noisy = acp.sqrt() * batch["latents"] + (1 - acp).sqrt() * batch["noise"]
    eps, _ = eps_and_sigma(params, noisy, t, batch["labels"], cfg)
    return (eps.float() - batch["noise"].float()).square().mean(), {}


def make_train_step(cfg: DiTConfig, *, lr=1e-4) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss's gradient (attention's through K7b), then one AdamW step without
    weight decay."""

    def train_step(params, opt_state, batch):
        (loss, _), grads = value_and_grad(train_loss, params, batch, cfg)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             lr=lr, weight_decay=0.0)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_sample_step(cfg: DiTConfig) -> Callable:
    """One DDIM update x_t -> x_{t_prev} (deterministic, eta 0):
    (params, x_t, t (B,), t_prev (B,), labels (B,)) -> x_{t_prev} in x_t's
    dtype; t_prev -1 ends the chain (ᾱ = 1)."""

    @torch.inference_mode()
    def sample_step(params, x_t, t, t_prev, labels):
        acp = alphas_cumprod(cfg, x_t.device)
        eps, _ = eps_and_sigma(params, x_t, t, labels, cfg)
        eps = eps.float()
        a_t = acp[t.long()][:, None, None, None]
        a_p = torch.where(t_prev >= 0, acp[t_prev.long().clamp_min(0)],
                          1.0)[:, None, None, None]
        x0 = (x_t.float() - (1 - a_t).sqrt() * eps) / a_t.sqrt()
        return (a_p.sqrt() * x0 + (1 - a_p).sqrt() * eps).to(x_t.dtype)

    return sample_step
