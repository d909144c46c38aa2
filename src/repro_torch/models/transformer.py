"""Decoder-only transformer LM: dense and MoE, serving and training on one
device.

Counterpart of ``repro.models.transformer``: GQA with RoPE, ``relu2`` /
``swiglu`` MLPs or a Mixture-of-Experts layer (``models.moe``), a
full-sequence forward, the serving prefill that fills the KV cache, the
one-token decode step, and the training loss (sequence-chunked cross
entropy plus the MoE balance loss) with the AdamW train step.
Parameters are stacked on a leading layer dim as in the reference; the
layer loop is a Python loop over them (the reference's ``scan``), through
``layers.scan_layers``, which checkpoints each layer of the training
forward under ``cfg.remat_policy``; prefill and decode run it without
remat, as the reference does.  One card has nothing to shard, so the
reference's ``rules`` argument is gone.

For serving, matrices, the embedding and the head are stored in bf16: the
reference keeps float32 and casts to bf16 at every use, which gives the
same values, so the port casts once (minitron-8b: 15.5 GB instead of
30.9).  Training keeps float32 master weights (``dtype=torch.float32`` at
``init_params`` / ``params_from_numpy``), which every use casts to bf16
as the reference does; on bf16 weights the cast is a no-op.  The norm
scales stay float32, as the reference's norms read them, and so does the
MoE router, which the reference routes with in float32 (a bf16 router
changes the top-k picks).  Attention over the full sequence runs
through K7 (``layers.chunked_attention``); the projections, the MLP and
the head are plain matmuls, as the reference leaves them to XLA, and so
is the decode step's masked softmax over the cache.  An MoE layer takes
its capacity over the tokens of the call: B·S at prefill and in
``forward``, B at decode, as the reference's.  The decode step writes
the new K/V row into the cache in place (the reference returns an
updated copy).

The serving entry points (``forward``, ``init_cache``, the prefill and
decode steps) run under ``torch.inference_mode``; ``forward_hidden`` and
``loss_fn`` run under autograd, and ``init_params`` / ``params_from_numpy``
return ordinary tensors (made under ``torch.no_grad``), which both take.

Not ported yet: the dry-run analytics and the expert-parallel exchange of
MoE.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers, moe as moe_lib
from repro_torch.optim import adamw_update
from repro_torch.tree import value_and_grad


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # variants
    qk_norm: bool = False
    mlp_act: str = "swiglu"          # "swiglu" | "relu2"
    tie_embeddings: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    # attention chunking
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # the reference's training and dry-run knobs, kept so configs read
    # alike.  ``remat_policy`` acts: ``forward_hidden`` checkpoints each
    # layer under it.  ``attn_step_remat`` shapes the reference's
    # ``chunked_attention`` KV scan, which K7 replaces; K7 keeps only the
    # lse, so nothing reads it.
    binary_mlp: bool = False
    unroll: bool = False
    remat_policy: str = "nothing"
    attn_step_remat: bool = True

    def __post_init__(self):
        if self.mlp_act not in ("swiglu", "relu2"):
            raise ValueError(f"unknown mlp_act {self.mlp_act!r}")

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def padded_experts(self, ep: int) -> int:
        return moe_lib.padded_experts(self.n_experts, ep)

    def param_count(self, ep: int = 1) -> int:
        d, l = self.d_model, self.n_layers
        attn = d * self.qkv_dim + 2 * d * self.kv_dim + self.qkv_dim * d
        if self.moe:
            e = self.n_experts
            mlp = d * e + 3 * e * d * self.d_ff_expert
        else:
            mlp = (3 if self.mlp_act == "swiglu" else 2) * d * self.d_ff
        norms = 2 * d + (2 * self.d_head if self.qk_norm else 0)
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return l * (attn + mlp + norms) + embed + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        attn = d * self.qkv_dim + 2 * d * self.kv_dim + self.qkv_dim * d
        mlp = d * self.n_experts + 3 * self.top_k * d * self.d_ff_expert
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return l * (attn + mlp + 2 * d) + embed + d


def padded_vocab(vocab: int, multiple: int) -> int:
    """Vocab padded to a multiple (the reference pads to its TP degree);
    pad ids are masked to -1e30 in the logits and never decoded.  Padded
    parameters come across from the reference through
    ``params_from_numpy``."""
    return -(-vocab // multiple) * multiple


# (name, shape without L, fan-in or 0 for a norm scale of ones); fan-ins
# are the reference's ``_stack``'s: shape[0] of a matrix, shape[1] of an
# expert stack.
def _layer_shapes(cfg: LMConfig, ep: int = 1
                  ) -> list[tuple[str, tuple[int, ...], int]]:
    d = cfg.d_model
    shapes = [("ln1", (d,), 0), ("ln2", (d,), 0),
              ("wq", (d, cfg.qkv_dim), d), ("wk", (d, cfg.kv_dim), d),
              ("wv", (d, cfg.kv_dim), d), ("wo", (cfg.qkv_dim, d),
                                           cfg.qkv_dim)]
    if cfg.qk_norm:
        shapes += [("q_norm", (cfg.d_head,), 0),
                   ("k_norm", (cfg.d_head,), 0)]
    if cfg.moe:
        e, fe = cfg.padded_experts(ep), cfg.d_ff_expert
        return shapes + [("router", (d, e), d), ("we_gate", (e, d, fe), d),
                         ("we_up", (e, d, fe), d),
                         ("we_down", (e, fe, d), fe)]
    if cfg.mlp_act == "swiglu":
        shapes.append(("w_gate", (d, cfg.d_ff), d))
    shapes += [("w_up", (d, cfg.d_ff), d), ("w_down", (cfg.d_ff, d),
                                            cfg.d_ff)]
    return shapes


# Kept in float32: the norm scales and the MoE router.
_FLOAT32 = frozenset({"ln1", "ln2", "q_norm", "k_norm", "final_norm",
                      "router"})


# Elements of one float32 draw: each tensor is drawn in row blocks of at
# most this size (command-r's (256000, 8192) embedding would otherwise
# need an 8.4 GB float32 temporary beside the layers).
_DRAW_ELEMENTS = 1 << 26


@torch.no_grad()
def init_params(cfg: LMConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = layers.COMPUTE_DTYPE) -> dict:
    """Stacked-layer parameters with the reference's shapes at one device
    (``ep = 1``) and its scales (matrices N(0, 1/fan_in), embedding and
    head N(0, 0.02²), norms 1), drawn in float32 from ``generator`` (on
    ``device``) one layer at a time, the embedding and head in row blocks,
    and stored in ``dtype`` (bf16 to serve, float32 as training's master
    weights); norm scales and the MoE router float32."""
    device = resolve_device(device)
    l, d = cfg.n_layers, cfg.d_model

    def empty(name, shape):
        kind = torch.float32 if name in _FLOAT32 else dtype
        return torch.empty(shape, dtype=kind, device=device)

    def fill(t, std):            # t = N(0, std²), drawn in row blocks
        rows = max(1, _DRAW_ELEMENTS // max(1, t[0].numel()))
        for lo in range(0, t.shape[0], rows):
            block = t[lo:lo + rows]
            block.copy_(torch.randn(block.shape, generator=generator,
                                    device=device).mul_(std))
        return t

    lay: dict[str, torch.Tensor] = {}
    for name, shape, fan_in in _layer_shapes(cfg):
        if not fan_in:
            lay[name] = torch.ones((l, *shape), device=device)
            continue
        lay[name] = empty(name, (l, *shape))
        for i in range(l):
            fill(lay[name][i], 1.0 / math.sqrt(fan_in))
    params = {"embed": fill(empty("embed", (cfg.vocab, d)), 0.02),
              "layers": lay, "final_norm": torch.ones((d,), device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = fill(empty("lm_head", (d, cfg.vocab)), 0.02)
    return params


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: LMConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = layers.COMPUTE_DTYPE) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree
    as numpy arrays (``jax.tree.map(np.asarray, params)``): the same
    values, matrices in ``dtype`` (bf16, the reference's cast at use, or
    float32 to train), norm scales and the MoE router float32.  An expert
    dim padded by a reference built with ``ep > 1`` comes across as it
    is: the router masks the padding experts by ``cfg.n_experts``."""
    device = resolve_device(device)
    want = {name for name, _, _ in _layer_shapes(cfg)}
    if set(tree["layers"]) != want:
        raise ValueError(f"layer params {sorted(tree['layers'])} do not "
                         f"match {cfg.name}'s {sorted(want)}")
    if cfg.moe:
        e_pad = np.shape(tree["layers"]["router"])[-1]
        if e_pad < cfg.n_experts or any(
                np.shape(tree["layers"][n])[1] != e_pad
                for n in ("we_gate", "we_up", "we_down")):
            raise ValueError(f"{cfg.name}: expert dims do not hold "
                             f"{cfg.n_experts} experts")

    def conv(name, a):   # a copy: arrays from jax are read-only
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device, torch.float32 if name in _FLOAT32
                    else dtype).contiguous()

    out = {name: conv(name, a) for name, a in tree.items()
           if name != "layers"}
    out["layers"] = {name: conv(name, a)
                     for name, a in tree["layers"].items()}
    return out


def _layer_params(params: dict, cfg: LMConfig) -> list[dict]:
    """The stacked layer parameters cut into one dict per layer (views)."""
    lay = params["layers"]
    return [{name: t[i] for name, t in lay.items()}
            for i in range(cfg.n_layers)]


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _qkv(hnorm, lp, cfg: LMConfig, positions):
    """q (B, S, H, hd), k and v (B, S, KV, hd) of the normed hidden, with
    RoPE on q and k."""
    b, s, _ = hnorm.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cd = layers.COMPUTE_DTYPE
    q = (hnorm @ lp["wq"].to(cd)).reshape(b, s, h, hd)
    k = (hnorm @ lp["wk"].to(cd)).reshape(b, s, kvh, hd)
    v = (hnorm @ lp["wv"].to(cd)).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention(x, lp, cfg: LMConfig, positions):
    """Causal self-attention over the full sequence (prefill).  Returns
    (x + attention, k, v); k and v are what the cache keeps.  On one
    device the reference takes one q chunk of the whole sequence and a
    masked KV scan; K7 computes the same function on its triangle."""
    b, s, _ = x.shape
    hnorm = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(hnorm, lp, cfg, positions)
    o = layers.chunked_attention(q, k, v, causal=True, q_chunk=s,
                                 kv_chunk=min(cfg.kv_chunk, s))
    o = o.reshape(b, s, cfg.qkv_dim) @ lp["wo"].to(layers.COMPUTE_DTYPE)
    return x + o, k, v


def _mlp_dense(hnorm, lp, cfg: LMConfig):
    cd = layers.COMPUTE_DTYPE
    up = hnorm @ lp["w_up"].to(cd)
    if cfg.mlp_act == "swiglu":
        gate = hnorm @ lp["w_gate"].to(cd)
        hmid = torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    else:                                        # relu2, squared in bf16
        hmid = torch.relu(up).square()
    return hmid @ lp["w_down"].to(cd)


def _mlp_or_moe(x, lp, cfg: LMConfig):
    """x + the MLP or the MoE layer of the normed x; returns (x, aux), aux
    None for a dense MLP.  An MoE layer routes the call's tokens flat: B·S
    of them over (B, S, D), B over a decode step's (B, D)."""
    hnorm = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if not cfg.moe:
        return x + _mlp_dense(hnorm, lp, cfg), None
    out, aux = moe_lib.moe_apply(
        hnorm.reshape(-1, cfg.d_model), lp["router"], lp["we_gate"],
        lp["we_up"], lp["we_down"], n_experts=cfg.n_experts,
        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        act=cfg.mlp_act)
    return x + out.reshape(x.shape), aux


def _embed(params, tokens):
    return params["embed"][tokens].to(layers.COMPUTE_DTYPE)


def _head(params, cfg: LMConfig):
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(layers.COMPUTE_DTYPE)


def _mask_pad_vocab(logits, cfg: LMConfig):
    """-1e30 on padded vocab columns (argmax/softmax never pick them)."""
    v_pad = logits.shape[-1]
    if v_pad == cfg.vocab:
        return logits
    mask = torch.arange(v_pad, device=logits.device) < cfg.vocab
    # A scalar fill, not a tensor made from a host value: that would be a
    # host-to-device copy, which a captured decode step cannot hold.
    return torch.where(mask, logits, -1e30)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LMConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed + all layers + final norm.  Returns (x (B, S, D), aux); aux
    is the MoE balance loss averaged over the layers, 0 for a dense
    model.  Differentiable: under autograd each layer is checkpointed
    (``layers.scan_layers`` under ``cfg.remat_policy``) and attention runs
    through K7, again in the recompute, and its backward, K7b."""
    x = _embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]

    def layer_body(x, lp):
        x, _, _ = _attention(x, lp, cfg, positions)
        return _mlp_or_moe(x, lp, cfg)

    x, auxs = layers.scan_layers(layer_body, x, params["layers"],
                                 n_layers=cfg.n_layers,
                                 remat_policy=cfg.remat_policy)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, (auxs.mean() if auxs is not None
               else torch.zeros((), device=x.device))


@torch.inference_mode()
def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits (B, S, Vp) in bf16, aux); padded
    vocab columns are masked to -1e30."""
    x, aux = forward_hidden(params, tokens, cfg)
    return _mask_pad_vocab(x @ _head(params, cfg), cfg), aux


# --------------------------------------------------------------------------
# Loss + train step
# --------------------------------------------------------------------------

def _log_partition(lg: torch.Tensor) -> torch.Tensor:
    """log Σ exp over the last dim of float32 logits, max-shifted as the
    reference writes it."""
    m = lg.amax(-1, keepdim=True)
    return m[..., 0] + torch.log(torch.exp(lg - m).sum(-1))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token CE of (..., V) logits, plus ``z_loss`` times the mean
    squared log-partition."""
    lg = logits.float()
    lse = _log_partition(lg)
    gold = torch.take_along_dim(lg, labels.long()[..., None], dim=-1)[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * lse.square().mean()
    return loss


def chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               vocab: int, z_loss: float = 1e-4,
               n_chunks: int = 8) -> torch.Tensor:
    """Sequence-chunked head matmul + cross-entropy, the reference's: the
    head and the CE are taken a chunk of positions at a time (the chunk
    count cut down until it divides S), padded vocab columns masked to
    -1e30, the sums divided by B·S at the end."""
    b, s, _ = x.shape
    width = head.shape[1]
    n_chunks = max(1, min(n_chunks, s))
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    pad_mask = (torch.arange(width, device=x.device) < vocab
                if width != vocab else None)
    total = torch.zeros((), device=x.device)
    ztotal = torch.zeros((), device=x.device)
    for i in range(n_chunks):
        lg = (x[:, i * cs:(i + 1) * cs] @ head).float()
        if pad_mask is not None:
            lg = torch.where(pad_mask, lg, -1e30)
        lse = _log_partition(lg)
        lc = labels[:, i * cs:(i + 1) * cs].long()
        gold = torch.take_along_dim(lg, lc[..., None], dim=-1)[..., 0]
        total = total + (lse - gold).sum()
        ztotal = ztotal + lse.square().sum()
    n_tok = b * s
    return total / n_tok + z_loss * ztotal / n_tok


def loss_fn(params: dict, batch: dict, cfg: LMConfig,
            aux_weight: float = 0.01):
    """(CE + ``aux_weight`` · MoE balance loss, {"ce", "aux"}) of one batch
    of ``tokens`` and next-token ``labels`` (B, S)."""
    x, aux = forward_hidden(params, batch["tokens"], cfg)
    ce = chunked_ce(x, _head(params, cfg), batch["labels"], cfg.vocab)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: LMConfig, *, lr=3e-4) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss's gradient over every leaf (attention's through K7b), then one
    AdamW step with the reference's defaults.  ``lr`` is a float or a
    schedule."""

    def train_step(params, opt_state, batch):
        (loss, parts), grads = value_and_grad(loss_fn, params, batch, cfg)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             lr=lr)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


# --------------------------------------------------------------------------
# Serving: prefill + decode over a KV cache
# --------------------------------------------------------------------------

@torch.inference_mode()
def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda") -> dict:
    """Zero KV cache in the reference's (L, B, KV, S, hd) layout, bf16."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=layers.COMPUTE_DTYPE,
                             device=device),
            "v": torch.zeros(shape, dtype=layers.COMPUTE_DTYPE,
                             device=device)}


def make_prefill_step(cfg: LMConfig, max_seq: int) -> Callable:
    """Prefill: (params, tokens (B, S)) -> (the last position's logits
    (B, Vp), a KV cache of ``max_seq`` filled at [0, S)).  K and v are
    computed once a layer, for attention and for the cache."""

    @torch.inference_mode()
    def prefill_step(params, tokens):
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq "
                             f"{max_seq}")
        cache = init_cache(cfg, b, max_seq, tokens.device)
        x = _embed(params, tokens)
        positions = torch.arange(s, device=tokens.device)[None]
        for i, lp in enumerate(_layer_params(params, cfg)):
            x, k, v = _attention(x, lp, cfg, positions)
            x, _ = _mlp_or_moe(x, lp, cfg)
            cache["k"][i, :, :, :s] = k.transpose(1, 2)
            cache["v"][i, :, :, :s] = v.transpose(1, 2)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        # Serving prefill only needs the last position's logits.
        return x[:, -1, :] @ _head(params, cfg), cache

    return prefill_step


def make_decode_step(cfg: LMConfig, max_seq: int) -> Callable:
    """One decode step: (params, cache, tokens (B, 1), pos) -> (logits
    (B, Vp), cache).  Every row writes its K/V at ``pos`` (one global
    position, as the reference) and attends to cache positions <= pos
    through a float32 masked softmax; the cache is updated in place.

    ``pos`` is a Python int (checked against ``max_seq`` here) or a 0-dim
    int64 tensor on the cache's device, the form a captured step reads:
    the K/V row is then written by ``index_copy_`` at the device index,
    the counterpart of the reference's ``dynamic_update_slice``, and the
    caller, which knows the position as an int, checks its range.  Both
    forms give the same bits."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kvh

    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos):
        on_device = torch.is_tensor(pos)
        if not on_device and not 0 <= pos < max_seq:
            raise ValueError(f"decode position {pos} outside [0, "
                             f"{max_seq})")
        b = tokens.shape[0]
        dev = tokens.device
        x = _embed(params, tokens[:, 0])
        if on_device:
            positions = pos.to(torch.int32).reshape(1, 1).expand(b, 1)
            index = pos.reshape(1)
        else:
            positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
        valid = torch.arange(max_seq, device=dev) <= pos
        for i, lp in enumerate(_layer_params(params, cfg)):
            hnorm = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = _qkv(hnorm[:, None], lp, cfg, positions)
            for name, new in (("k", k), ("v", v)):
                if on_device:        # (B, KV, 1, hd) into (B, KV, S, hd)
                    cache[name][i].index_copy_(2, index,
                                               new.transpose(1, 2))
                else:
                    cache[name][i, :, :, pos] = new[:, 0]
            qf = q.reshape(b, kvh, g, hd).float() / math.sqrt(hd)
            s = torch.einsum("bhgd,bhsd->bhgs", qf, cache["k"][i].float())
            s = torch.where(valid, s, -1e30)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            o = torch.einsum("bhgs,bhsd->bhgd", p / p.sum(-1, keepdim=True),
                             cache["v"][i].float())
            x = x + (o.reshape(b, h * hd).to(x.dtype)
                     @ lp["wo"].to(layers.COMPUTE_DTYPE))
            x, _ = _mlp_or_moe(x, lp, cfg)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _mask_pad_vocab(x @ _head(params, cfg), cfg), cache

    return decode_step
