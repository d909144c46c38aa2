"""Diffusion Transformer (DiT-L/2, DiT-XL/2; Peebles & Xie,
arXiv:2212.09748), on one device or on a mesh.

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
outputs are kept, the rest recomputed).  Attention goes through K7
(``layers.chunked_attention``) and, under autograd, K7b; the projections,
the MLP and the conditioning MLP are plain matmuls, as the reference
leaves them to XLA.  The conditioning runs in float32 and is cast to bf16
only after its last SiLU, as the reference's.  ``forward`` serves under
``torch.inference_mode``; ``eps_and_sigma`` is the same function under
autograd.

On a mesh (``rules``: the reference's ``param_specs``, its collectives
written out through ``models.zoo_mesh.Layout``; every entry point takes
the whole batch on every rank and cuts its own part): the batch over the
batch axes, or, where the batch does not divide them, the tokens over the
last batch axis (the reference's ``tspec``: each rank's queries over its
tokens, K and V gathered over all of them); the layers' leaves gathered
over ``fsdp`` a layer at a time; QKV column-parallel over ``model``, each
rank taking its own heads' columns of the gathered ``wqkv``, K7 on its
H/tp heads over all the tokens; ``wo`` and ``w2`` row-parallel, ``w1``
column-parallel.  The residual stream is whole over ``model``, or, with
``cfg.seq_shard`` and the batch cut, cut by tokens over ``model``
between blocks (Megatron-SP, the reference's ``seq_shard``): each block
all-gathers its normed tokens before each column-parallel product and
reduce-scatters each row-parallel one (``layers.row_parallel(...,
scatter_axis=1)``) instead of all-reducing it.  adaLN: ``ada_w``'s
columns are cut over ``model``, so each rank regresses its block of the
(B, 6·D) modulations and the blocks are all-gathered before
``modulate`` (B·6·D values: far fewer than ``ada_w``'s D·6·D); the
backward takes each rank's block of their cotangent, summed over the
ranks where the residual is cut by tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.models import layers
from repro_torch.models.zoo_mesh import Layout, shard_params
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
    # the reference's dry-run knob, kept so configs read alike
    unroll: bool = False
    # activation-checkpoint policy (``layers.REMAT_POLICIES``)
    remat_policy: str = "nothing"
    # Megatron-SP on a mesh: the residual stream's tokens cut over
    # ``model`` between blocks
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


def param_specs(cfg: DiTConfig, rules) -> dict:
    """The reference's spec tree (FSDP over ``rules.fsdp``, heads, the MLP
    and the modulations' columns over ``rules.model``)."""
    fs, mp = rules.fsdp, rules.model
    d, ff = cfg.d_model, cfg.d_ff
    lay = {
        "wqkv": P(None, fs, rules.shard_if(3 * d, mp)),
        "wo": P(None, rules.shard_if(d, mp), fs),
        "w1": P(None, fs, rules.shard_if(ff, mp)),
        "w2": P(None, rules.shard_if(ff, mp), fs),
        "ada_w": P(None, fs, rules.shard_if(6 * d, mp)),
        "ada_b": P(None, None),
    }
    return {
        "patch_w": P(None, fs), "patch_b": P(None),
        "pos": P(None, None),
        "t_mlp1": P(None, fs), "t_mlp2": P(fs, None),
        "label_emb": P(None, fs),
        "layers": lay,
        "final_ada_w": P(fs, None), "final_ada_b": P(None),
        "final_w": P(fs, None), "final_b": P(None),
    }


def abstract_params(cfg: DiTConfig, dtype: torch.dtype = torch.float32
                    ) -> dict:
    """``init_params``' tree of full shapes and dtypes as meta tensors (no
    memory)."""
    return init_params(cfg, None, "meta", dtype)


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: DiTConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32,
                      rules=None) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree as
    numpy arrays: the same values and layouts, stored as
    :func:`init_params` stores them; with ``rules`` this rank's slices of
    :func:`param_specs`."""
    full = layers.tree_from_numpy(tree, resolve_device(device), dtype,
                                  keep32=FLOAT32_LEAVES)
    return shard_params(full, rules and param_specs(cfg, rules), rules)


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


class _Plan:
    """One rank's layout of a batch of ``b`` latents of ``s`` tokens under
    ``rules`` (None: one device): which rows and tokens it runs, and each
    block's hooks."""

    def __init__(self, cfg: DiTConfig, rules, b: int, s: int):
        self.cfg, self.lay = cfg, Layout(rules)
        lay = self.lay
        self.row_axes = lay.batch_axes(b)
        self.tok_axis = None          # tokens over the last batch axis
        self.seq = self.tp_heads = self.wo_rows = self.ff_cols = False
        self.ada_cols = False
        if not lay.on:
            return
        self.specs = param_specs(cfg, rules)
        if not self.row_axes:
            self.tok_axis = rules.shard_if(s, rules.batch[-1])
        ls, tp = self.specs["layers"], lay.tp
        self.tp_heads = (tp > 1 and ls["wqkv"][2] is not None
                         and cfg.n_heads % tp == 0)
        self.wqkv_cols = tp > 1 and ls["wqkv"][2] is not None
        self.wo_rows = tp > 1 and ls["wo"][1] is not None
        self.ff_cols = tp > 1 and ls["w1"][2] is not None
        self.ada_cols = tp > 1 and ls["ada_w"][2] is not None
        # Megatron-SP needs every block product cut over ``model``; else
        # the residual stays whole (the same function)
        self.seq = (cfg.seq_shard and self.tok_axis is None and tp > 1
                    and s % tp == 0 and self.tp_heads and self.wo_rows
                    and self.ff_cols and self.ada_cols)
        self.rows = rules.batch_cut(b)
        if self.tok_axis is not None:
            self.tok_comm = rules.comm(self.tok_axis)

    # ---- the rank's part of the batch ---------------------------------------
    def cut_rows(self, t: torch.Tensor) -> torch.Tensor:
        return self.rows.take(t) if self.lay.on else t

    def cut_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """(b, S, ...) -> the rank's tokens (over the last batch axis)."""
        if self.tok_axis is None:
            return t
        c = self.tok_comm
        k = t.shape[1] // c.size
        return t[:, c.index * k:(c.index + 1) * k]

    def whole(self, out: torch.Tensor) -> torch.Tensor:
        """(rank's rows, rank's tokens, ...) -> the whole batch's on every
        rank, each rank's cotangent its own block."""
        if self.tok_axis is not None:
            out = sharding.gather_model(out, self.tok_comm, 1)
        if self.row_axes:
            out = sharding.gather_model(out, self.lay.rules.comm(
                self.row_axes), 0)
        return out

    def loss_axes(self) -> tuple[str, ...]:
        """The axes a loss sum of the rank's part is summed over."""
        return self.row_axes or ((self.tok_axis,) if self.tok_axis else ())

    # ---- block hooks --------------------------------------------------------
    def layer(self, lp: dict) -> dict:
        """The layer's leaves whole over ``fsdp``; ``wqkv`` the rank's heads'
        q, k and v columns (gathered over ``model``, reduce-scatter
        backward), or whole where attention runs whole."""
        lay = self.lay
        if not lay.on:
            return lp
        lp = lay.layer(lp, self.specs["layers"])
        if self.tp_heads:
            (w,) = sharding.gather_fsdp([lp["wqkv"]], [-1], lay.model)
            i, n = lay.model.index, self.cfg.d_model // lay.tp
            lp["wqkv"] = w.unflatten(-1, (3, lay.tp, n))[..., i, :].flatten(
                -2)
        elif self.wqkv_cols:
            (lp["wqkv"],) = lay.whole([lp["wqkv"]],
                                      [P(None, lay.rules.model)])
        if self.seq:
            lp["ada_b"] = sharding.copy_to_model(lp["ada_b"], lay.model)
        return lp

    def mods(self, cvec: torch.Tensor, lp: dict) -> torch.Tensor:
        """cvec (B, D) -> the block's (B, 6·D) modulations, whole."""
        cd = layers.COMPUTE_DTYPE
        if not self.ada_cols:
            return cvec @ lp["ada_w"].to(cd) + lp["ada_b"].to(cd)
        m = sharding.copy_to_model(cvec, self.lay.model) @ lp["ada_w"].to(cd)
        if self.seq:   # each rank's tokens: its cotangent a part of it
            (m,) = sharding.gather_fsdp([m], [-1], self.lay.model)
        else:
            m = sharding.gather_model(m, self.lay.model, -1)
        return m + lp["ada_b"].to(cd)

    def enter(self, h: torch.Tensor, cut: bool) -> torch.Tensor:
        """The input of a column-parallel product: its tokens gathered
        over ``model`` (Megatron-SP), or whole already."""
        if self.seq:
            return sharding.gather_fsdp([h], [1], self.lay.model)[0]
        return self.lay.col_in(h) if cut else h

    def out(self, a: torch.Tensor, w: torch.Tensor, cut: bool,
            whole_in: bool = False) -> torch.Tensor:
        """A row-parallel product (reduce-scattered by tokens under
        Megatron-SP), or the plain one."""
        if not cut:
            return a @ w.to(layers.COMPUTE_DTYPE)
        if whole_in:
            a = self.lay.part(a)
        return self.lay.row(a, w, 1 if self.seq else None)

    def kv(self, k: torch.Tensor, v: torch.Tensor):
        """K and V over all the tokens (the queries stay the rank's)."""
        if self.tok_axis is None:
            return k, v
        k, v = sharding.gather_fsdp([k, v], [1, 1], self.tok_comm)
        return k.contiguous(), v.contiguous()


def _tokens(params: dict, latents: torch.Tensor, t: torch.Tensor,
            labels: torch.Tensor, cfg: DiTConfig, plan: _Plan):
    """The final projection's (b, s, 2·p·p·C) tokens of the rank's part of
    the batch (its rows and tokens; all of them on one device)."""
    lay = plan.lay
    b, hl = latents.shape[:2]
    cd = layers.COMPUTE_DTYPE
    grid = hl // cfg.patch
    s = grid * grid
    fs = (lambda names: [params[n] for n in names]) if not lay.on else (
        lambda names: lay.fsdp([params[n] for n in names],
                               [plan.specs[n] for n in names]))
    patch_w, t_mlp1, t_mlp2, label_emb, final_ada_w, final_w = fs(
        ["patch_w", "t_mlp1", "t_mlp2", "label_emb", "final_ada_w",
         "final_w"])
    x = plan.cut_tokens(patchify(latents, cfg.patch)).to(cd) @ patch_w.to(cd)
    x = x + params["patch_b"].to(cd)
    pos = params["pos"]
    if pos.shape[0] != s:
        side = math.isqrt(pos.shape[0])
        pos = layers.resize_grid(pos.reshape(1, side, side, -1), grid,
                                 grid).reshape(s, -1)
    x = x + plan.cut_tokens(pos.to(cd)[None])
    if plan.seq:
        x = sharding.split_model(x, lay.model, 1)

    temb = timestep_embedding(t) @ t_mlp1.float()
    cvec = (layers.silu(temb) @ t_mlp2.float()
            + label_emb.float()[labels.long()])               # (B, D) f32
    cvec = layers.silu(cvec).to(cd)

    hd = cfg.d_head

    def layer_body(x, lp):
        lp = plan.layer(lp)
        sh1, sc1, g1, sh2, sc2, g2 = plan.mods(cvec, lp).chunk(6, dim=-1)
        hn = layers.modulate(layers.layer_norm(x, None, None), sh1, sc1)
        qkv = plan.enter(hn, plan.tp_heads) @ lp["wqkv"].to(cd)
        w = qkv.shape[-1] // 3                   # this rank's heads' width
        q, k, v = (t_.reshape(b, -1, w // hd, hd).contiguous()
                   for t_ in qkv.split(w, dim=-1))
        k, v = plan.kv(k, v)
        sq = q.shape[1]
        o = layers.chunked_attention(q, k, v, causal=False, q_chunk=sq,
                                     kv_chunk=min(1024, sq))
        o = plan.out(o.reshape(b, sq, w), lp["wo"], plan.wo_rows,
                     whole_in=not plan.tp_heads)
        x = x + g1[:, None, :] * o
        hn = layers.modulate(layers.layer_norm(x, None, None), sh2, sc2)
        out = plan.out(layers.gelu(plan.enter(hn, plan.ff_cols)
                                   @ lp["w1"].to(cd)), lp["w2"],
                       plan.ff_cols)
        return x + g2[:, None, :] * out, None

    x, _ = layers.scan_layers(layer_body, x, params["layers"],
                              n_layers=cfg.n_layers,
                              remat_policy=cfg.remat_policy)
    if plan.seq:
        x = sharding.gather_model(x, lay.model, 1)
    fmods = (cvec @ final_ada_w.to(cd) + params["final_ada_b"].to(cd))
    fsh, fsc = fmods.chunk(2, dim=-1)
    x = layers.modulate(layers.layer_norm(x, None, None), fsh, fsc)
    return x @ final_w.to(cd) + params["final_b"].to(cd)


def eps_and_sigma(params: dict, latents: torch.Tensor, t: torch.Tensor,
                  labels: torch.Tensor, cfg: DiTConfig, rules=None):
    """latents (B, Hl, Wl, C), t (B,) int, labels (B,) int -> (eps,
    sigma_raw), each (B, Hl, Wl, C) in bf16, under autograd (each layer
    checkpointed under ``cfg.remat_policy``).  With ``rules``: the whole
    batch in on every rank, the rank's slices; the whole outputs out."""
    b, hl, _, c = latents.shape
    grid = hl // cfg.patch
    plan = _Plan(cfg, rules, b, grid * grid)
    out = plan.whole(_tokens(params, plan.cut_rows(latents),
                             plan.cut_rows(t), plan.cut_rows(labels), cfg,
                             plan))
    eps, sigma = out.chunk(2, dim=-1)
    return (unpatchify(eps, cfg.patch, grid, c),
            unpatchify(sigma, cfg.patch, grid, c))


@torch.inference_mode()
def forward(params: dict, latents: torch.Tensor, t: torch.Tensor,
            labels: torch.Tensor, cfg: DiTConfig, rules=None):
    """Serving: (eps, sigma_raw), each (B, Hl, Wl, C) in bf16."""
    return eps_and_sigma(params, latents, t, labels, cfg, rules)


# --------------------------------------------------------------------------
# Diffusion schedule (linear betas, DDPM) + steps
# --------------------------------------------------------------------------

def alphas_cumprod(cfg: DiTConfig, device=None) -> torch.Tensor:
    """ᾱ_t of the linear beta schedule 1e-4 .. 0.02, float32."""
    betas = torch.linspace(1e-4, 0.02, cfg.n_train_timesteps,
                           dtype=torch.float32, device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def train_loss(params: dict, batch: dict, cfg: DiTConfig, rules=None):
    """batch: latents (B, H, W, C), labels (B,), t (B,), noise (B, H, W,
    C).  (MSE of the predicted ε against the noise, {}).  With ``rules``:
    the whole batch on every rank, each rank's part of the error summed
    over the batch axes; the loss is the global one, the same on every
    rank.  Where neither the rows nor the tokens cut over every batch
    axis, the ranks of the axes left out hold the same part: the sum
    counts it once a copy and is divided by the copies too."""
    t = batch["t"].long()
    acp = alphas_cumprod(cfg, t.device)[t][:, None, None, None]
    noisy = acp.sqrt() * batch["latents"] + (1 - acp).sqrt() * batch["noise"]
    if rules is None:
        eps, _ = eps_and_sigma(params, noisy, t, batch["labels"], cfg)
        return (eps.float() - batch["noise"].float()).square().mean(), {}
    b, hl = noisy.shape[:2]
    grid = hl // cfg.patch
    plan = _Plan(cfg, rules, b, grid * grid)
    copies = plan.lay.dp // rules.axis_size(plan.loss_axes())
    out = _tokens(params, plan.cut_rows(noisy), plan.cut_rows(t),
                  plan.cut_rows(batch["labels"]), cfg, plan)
    pd = cfg.patch_dim
    noise = plan.cut_tokens(patchify(plan.cut_rows(batch["noise"]),
                                     cfg.patch))
    part = (out[..., :pd].float() - noise.float()).square().sum()
    total = sharding.psum(part, plan.lay.batch)
    return total / (batch["noise"].numel() * copies), {}


def make_train_step(cfg: DiTConfig, rules=None, *, lr=1e-4) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss's gradient (attention's through K7b), then one AdamW step without
    weight decay.  With ``rules`` (every rank calls it on its slices and
    the whole batch): the gradient summed over the batch axes a leaf is
    replicated over, clipped by the global norm over every rank's
    leaves."""
    specs = param_specs(cfg, rules) if rules is not None else None
    lay = Layout(rules)

    def train_step(params, opt_state, batch):
        (loss, _), grads = value_and_grad(train_loss, params, batch, cfg,
                                          rules)
        grads = lay.sync(grads, specs)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             lr=lr, weight_decay=0.0,
                                             rules=rules, specs=specs)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_sample_step(cfg: DiTConfig, rules=None) -> Callable:
    """One DDIM update x_t -> x_{t_prev} (deterministic, eta 0):
    (params, x_t, t (B,), t_prev (B,), labels (B,)) -> x_{t_prev} in x_t's
    dtype; t_prev -1 ends the chain (ᾱ = 1).  With ``rules``, on every
    rank: the whole batch in, the whole update out."""

    @torch.inference_mode()
    def sample_step(params, x_t, t, t_prev, labels):
        acp = alphas_cumprod(cfg, x_t.device)
        eps, _ = eps_and_sigma(params, x_t, t, labels, cfg, rules)
        eps = eps.float()
        a_t = acp[t.long()][:, None, None, None]
        a_p = torch.where(t_prev >= 0, acp[t_prev.long().clamp_min(0)],
                          1.0)[:, None, None, None]
        x0 = (x_t.float() - (1 - a_t).sqrt() * eps) / a_t.sqrt()
        return (a_p.sqrt() * x0 + (1 - a_p).sqrt() * eps).to(x_t.dtype)

    return sample_step
