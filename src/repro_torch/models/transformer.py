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
remat, as the reference does.

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

With ``rules`` (a :class:`~repro_torch.distributed.sharding.Rules` over a
:class:`~repro_torch.launch.mesh.Mesh`) the serving entry points run
sharded, one process a rank: ``param_specs`` and ``cache_specs`` are the
reference's layouts, each rank holds exactly the slice its spec names
(``init_params`` / ``params_from_numpy`` with ``rules`` return it), and
the reference's GSPMD partitioning is written out as explicit collectives
(see ``_Sharded``).  Tokens go in whole on every rank, and the logits
come out whole on every rank; the KV cache stays the rank's shard.
``loss_fn`` and ``make_train_step`` take ``rules`` too: each rank its
slices and its rows of the batch (``rules.batch_cut``: any batch, as the
reference's ``batch_spec`` places it), every gradient collective a
differentiable op of ``distributed.sharding``.  ``rules=None`` is the
one-device path, unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, local_shard
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
                dtype: torch.dtype = layers.COMPUTE_DTYPE, *, ep: int = 1,
                vocab_pad_to: int = 1, rules=None) -> dict:
    """Stacked-layer parameters with the reference's shapes (the expert
    dim padded to a multiple of ``ep``, the vocab to one of
    ``vocab_pad_to``) and its scales (matrices N(0, 1/fan_in), embedding
    and head N(0, 0.02²), norms 1), drawn in float32 from ``generator``
    (on ``device``) one layer at a time, the embedding and head in row
    blocks, and stored in ``dtype`` (bf16 to serve, float32 as training's
    master weights); norm scales and the MoE router float32.  With
    ``rules`` every rank draws the same values and keeps only its slice
    of each (``param_specs``)."""
    device = resolve_device(device)
    l, d = cfg.n_layers, cfg.d_model
    v_pad = padded_vocab(cfg.vocab, vocab_pad_to)
    specs = param_specs(cfg, rules) if rules is not None else None

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

    def keep(t, spec):           # the rank's slice, an own copy
        if spec is None:
            return t
        return local_shard(t, spec, rules).contiguous().clone()

    lay: dict[str, torch.Tensor] = {}
    for name, shape, fan_in in _layer_shapes(cfg, ep):
        spec = specs["layers"][name] if specs is not None else None
        if not fan_in:
            lay[name] = keep(torch.ones((l, *shape), device=device), spec)
            continue
        if spec is None:
            lay[name] = empty(name, (l, *shape))
            for i in range(l):
                fill(lay[name][i], 1.0 / math.sqrt(fan_in))
            continue
        one = P(*list(spec)[1:])
        lay[name] = torch.stack([
            keep(fill(empty(name, shape), 1.0 / math.sqrt(fan_in)), one)
            for _ in range(l)])
    params = {"embed": keep(fill(empty("embed", (v_pad, d)), 0.02),
                            specs and specs["embed"]),
              "layers": lay, "final_norm": torch.ones((d,), device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(fill(empty("lm_head", (d, v_pad)), 0.02),
                                 specs and specs["lm_head"])
    return params


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: LMConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = layers.COMPUTE_DTYPE, *,
                      ep: int = 1, vocab_pad_to: int = 1,
                      rules=None) -> dict:
    """The port's parameters from the reference's ``init_params`` pytree
    as numpy arrays (``jax.tree.map(np.asarray, params)``): the same
    values, matrices in ``dtype`` (bf16, the reference's cast at use, or
    float32 to train), norm scales and the MoE router float32.  An expert
    dim padded by a reference built with ``ep > 1`` comes across as it
    is: the router masks the padding experts by ``cfg.n_experts``.  An
    expert dim or a vocab smaller than ``ep`` / ``vocab_pad_to`` ask for
    is padded with zeros (never routed, masked from the logits).  With
    ``rules`` each leaf is cut to the rank's slice (``param_specs``)."""
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
    specs = param_specs(cfg, rules) if rules is not None else None

    def pad(name, a):
        a = np.asarray(a, np.float32)
        widths = [(0, 0)] * a.ndim
        if name == "embed":
            widths[0] = (0, padded_vocab(a.shape[0], vocab_pad_to)
                         - a.shape[0])
        elif name == "lm_head":
            widths[1] = (0, padded_vocab(a.shape[1], vocab_pad_to)
                         - a.shape[1])
        elif name == "router":
            widths[2] = (0, moe_lib.padded_experts(a.shape[2], ep)
                         - a.shape[2])
        elif name in ("we_gate", "we_up", "we_down"):
            widths[1] = (0, moe_lib.padded_experts(a.shape[1], ep)
                         - a.shape[1])
        return np.pad(a, widths) if any(w[1] for w in widths) else a

    def conv(name, a, spec):   # a copy: arrays from jax are read-only
        t = torch.from_numpy(np.array(pad(name, a), dtype=np.float32))
        if spec is not None:
            t = local_shard(t, spec, rules)
        return t.to(device, torch.float32 if name in _FLOAT32
                    else dtype).contiguous()

    out = {name: conv(name, a, specs and specs[name])
           for name, a in tree.items() if name != "layers"}
    out["layers"] = {name: conv(name, a, specs and specs["layers"][name])
                     for name, a in tree["layers"].items()}
    return out


def abstract_params(cfg: LMConfig, ep: int = 1, vocab_pad_to: int = 1,
                    dtype: torch.dtype = layers.COMPUTE_DTYPE) -> dict:
    """``init_params``' tree of full shapes and dtypes as meta tensors (no
    memory): the ``like`` of an elastic restore."""
    lay = {name: torch.empty((cfg.n_layers, *shape), device="meta",
                             dtype=torch.float32 if name in _FLOAT32
                             or not fan_in else dtype)
           for name, shape, fan_in in _layer_shapes(cfg, ep)}
    v_pad = padded_vocab(cfg.vocab, vocab_pad_to)
    out = {"embed": torch.empty((v_pad, cfg.d_model), device="meta",
                                dtype=dtype),
           "layers": lay,
           "final_norm": torch.empty((cfg.d_model,), device="meta")}
    if not cfg.tie_embeddings:
        out["lm_head"] = torch.empty((cfg.d_model, v_pad), device="meta",
                                     dtype=dtype)
    return out


def param_specs(cfg: LMConfig, rules) -> dict:
    """The reference's spec tree of ``init_params`` (FSDP over
    ``rules.fsdp``, TP / EP over ``rules.model``)."""
    fs, mp = rules.fsdp, rules.model
    lay: dict[str, P] = {
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, fs, rules.shard_if(cfg.qkv_dim, mp)),
        "wk": P(None, fs, rules.shard_if(cfg.kv_dim, mp)),
        "wv": P(None, fs, rules.shard_if(cfg.kv_dim, mp)),
        "wo": P(None, rules.shard_if(cfg.qkv_dim, mp), fs),
    }
    if cfg.qk_norm:
        lay["q_norm"] = P(None, None)
        lay["k_norm"] = P(None, None)
    if cfg.moe:
        lay["router"] = P(None, None, None)
        lay["we_gate"] = P(None, mp, fs, None)
        lay["we_up"] = P(None, mp, fs, None)
        lay["we_down"] = P(None, mp, None, fs)
    else:
        ff = rules.shard_if(cfg.d_ff, mp)
        if cfg.mlp_act == "swiglu":
            lay["w_gate"] = P(None, fs, ff)
        lay["w_up"] = P(None, fs, ff)
        lay["w_down"] = P(None, ff, fs)
    specs = {
        "embed": P(rules.shard_if(padded_vocab(cfg.vocab, rules.tp), mp),
                   fs),
        "layers": lay,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(
            fs, rules.shard_if(padded_vocab(cfg.vocab, rules.tp), mp))
    return specs


def cache_specs(cfg: LMConfig, rules, batch: int, max_seq: int) -> dict:
    """Flash-decoding SP: the (L, B, KV, S, hd) cache's batch over the
    batch axes, its sequence over ``model`` (each whole where the size
    does not divide)."""
    spec = P(None, rules.batch_spec(batch), None,
             rules.shard_if(max_seq, rules.model), None)
    return {"k": spec, "v": spec}


def _layer_params(params: dict, cfg: LMConfig) -> list[dict]:
    """The stacked layer parameters cut into one dict per layer (views)."""
    lay = params["layers"]
    return [{name: t[i] for name, t in lay.items()}
            for i in range(cfg.n_layers)]


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _qkv(hnorm, lp, cfg: LMConfig, positions):
    """q (B, S, heads, hd), k and v (B, S, KV heads, hd) of the normed
    hidden, with RoPE on q and k: the heads of lp's wq / wk / wv columns
    (all of them on one device, a rank's under ``rules``)."""
    b, s, _ = hnorm.shape
    hd = cfg.d_head
    cd = layers.COMPUTE_DTYPE
    q = (hnorm @ lp["wq"].to(cd)).reshape(b, s, -1, hd)
    k = (hnorm @ lp["wk"].to(cd)).reshape(b, s, -1, hd)
    v = (hnorm @ lp["wv"].to(cd)).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention(x, lp, cfg: LMConfig, positions, *, kv_index=None,
               out_proj=None, col_in=None):
    """Causal self-attention over the full sequence (prefill).  Returns
    (x + attention, k, v); k and v are what the cache keeps.  On one
    device the reference takes one q chunk of the whole sequence and a
    masked KV scan; K7 computes the same function on its triangle.  A
    rank of a mesh gives the KV heads its q heads read (``kv_index``,
    into k's heads), its out-projection (``out_proj(o, lp)``) and what
    the normed input of its column-parallel q / k / v products passes
    through (``col_in``: ``copy_to_model``)."""
    b, s, _ = x.shape
    hnorm = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if col_in is not None:
        hnorm = col_in(hnorm)
    q, k, v = _qkv(hnorm, lp, cfg, positions)
    ka, va = k, v
    if kv_index is not None:
        ka, va = k.index_select(2, kv_index), v.index_select(2, kv_index)
    o = layers.chunked_attention(q, ka, va, causal=True, q_chunk=s,
                                 kv_chunk=min(cfg.kv_chunk, s))
    o = o.reshape(b, s, -1)
    o = (o @ lp["wo"].to(layers.COMPUTE_DTYPE) if out_proj is None
         else out_proj(o, lp))
    return x + o, k, v


def _mlp_hidden(hnorm, lp, cfg: LMConfig):
    cd = layers.COMPUTE_DTYPE
    up = hnorm @ lp["w_up"].to(cd)
    if cfg.mlp_act == "swiglu":
        gate = hnorm @ lp["w_gate"].to(cd)
        return torch.nn.functional.silu(gate.float()).to(up.dtype) * up
    return torch.relu(up).square()               # relu2, squared in bf16


def _mlp_or_moe(x, lp, cfg: LMConfig, *, down=None, experts=None,
                want_aux: bool = True, col_in=None):
    """x + the MLP or the MoE layer of the normed x; returns (x, aux), aux
    None for a dense MLP (and where ``want_aux`` is false).  An MoE layer
    routes the call's tokens flat: B·S of them over (B, S, D), B over a
    decode step's (B, D).  A rank of a mesh gives the MLP's down
    projection (``down(h, w_down)``), what the normed input of its
    column-parallel products passes through (``col_in``), and the MoE
    layer (``experts(tokens (T, D), lp) -> (out, aux)``)."""
    hnorm = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if not cfg.moe:
        if col_in is not None:
            hnorm = col_in(hnorm)
        h = _mlp_hidden(hnorm, lp, cfg)
        return x + (h @ lp["w_down"].to(layers.COMPUTE_DTYPE) if down is None
                    else down(h, lp["w_down"])), None
    tok = hnorm.reshape(-1, cfg.d_model)
    if experts is None:
        out, aux = moe_lib.moe_apply(
            tok, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.mlp_act,
            want_aux=want_aux)
    else:
        out, aux = experts(tok, lp)
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


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LMConfig,
                   rules=None, *, local_rows: bool = False,
                   batch_size: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed + all layers + final norm.  Returns (x (B, S, D), aux); aux
    is the MoE balance loss averaged over the layers, 0 for a dense
    model.  Differentiable: under autograd each layer is checkpointed
    (``layers.scan_layers`` under ``cfg.remat_policy``) and attention runs
    through K7, again in the recompute, and its backward, K7b.

    With ``rules``: the rank's batch rows of x (whole over ``model``), aux
    averaged over every shard too (``moe_apply``).  ``tokens`` are whole
    on every rank, or with ``local_rows`` the rank's rows already of a
    global batch of ``batch_size`` rows (``rules.batch_cut``: the train
    step's batch; by default a cut over every batch axis).  Differentiable
    there too: under autograd every collective runs through the
    differentiable ops of ``distributed.sharding`` (FSDP gathers whose
    backward reduce-scatters, ``copy_to_model`` into each column-parallel
    product, the row-parallel sums, the MoE's two ``all_to_all``), so the
    gradient of each rank's leaves is its part of the one-device gradient
    but for the sums over the batch axes (``sharding.sync_grads``)."""
    plan = _plan(cfg, rules, local_rows)
    b, s = tokens.shape
    x = plan.embed(params, tokens)
    positions = torch.arange(s, device=tokens.device)[None]
    if local_rows:
        b = batch_size if batch_size is not None else b * rules.dp

    def layer_body(x, lp):
        lp = plan.layer(lp)
        x, _, _ = plan.attention(x, lp, positions)
        return plan.mlp(x, lp, b)

    x, auxs = layers.scan_layers(layer_body, x, params["layers"],
                                 n_layers=cfg.n_layers,
                                 remat_policy=cfg.remat_policy)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, (auxs.mean() if auxs is not None
               else torch.zeros((), device=x.device))


@torch.inference_mode()
def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits (B, S, Vp) in bf16, aux); padded
    vocab columns are masked to -1e30.  With ``rules``, on every rank:
    the whole tokens in, the whole logits out."""
    x, aux = forward_hidden(params, tokens, cfg, rules)
    return _plan(cfg, rules).logits(params, x, tokens.shape[0]), aux


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
               n_chunks: int = 8, rules=None) -> torch.Tensor:
    """Sequence-chunked head matmul + cross-entropy, the reference's: the
    head and the CE are taken a chunk of positions at a time (the chunk
    count cut down until it divides S), padded vocab columns masked to
    -1e30, the sums divided by B·S at the end.

    With ``rules``, vocab-parallel: x and ``labels`` are the rank's batch
    rows (x whole over ``model``), ``head`` the rank's vocab columns
    (``param_specs`` cuts them over ``model``), x through
    ``copy_to_model``.  Each chunk takes the
    ``pmax`` of its max (no gradient: the shift cancels), one ``psum`` of
    Σ exp and of the gold logit (a label outside the rank's columns reads
    0), padded columns masked at their global index; the sums are summed
    over the batch axes and divided by the global B·S.  The full logits
    are never gathered."""
    b, s, _ = x.shape
    width = head.shape[1]
    n_chunks = max(1, min(n_chunks, s))
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    model = rules.comm(rules.model) if rules is not None else None
    lo = model.index * width if model is not None else 0
    if model is not None:
        x = sharding.copy_to_model(x, model)
    full = width * (model.size if model is not None else 1)
    pad_mask = (lo + torch.arange(width, device=x.device) < vocab
                if full != vocab else None)
    total = torch.zeros((), device=x.device)
    ztotal = torch.zeros((), device=x.device)
    for i in range(n_chunks):
        lg = (x[:, i * cs:(i + 1) * cs] @ head).float()
        if pad_mask is not None:
            lg = torch.where(pad_mask, lg, -1e30)
        lc = labels[:, i * cs:(i + 1) * cs].long()
        if model is None:
            lse = _log_partition(lg)
            gold = torch.take_along_dim(lg, lc[..., None], dim=-1)[..., 0]
        else:
            m = model.pmax(lg.detach().amax(-1, keepdim=True))
            idx = lc - lo
            inside = (idx >= 0) & (idx < width)
            gold = torch.take_along_dim(lg, idx.clamp(0, width - 1)[..., None],
                                        dim=-1)[..., 0]
            both = sharding.reduce_from_model(torch.stack(
                [torch.exp(lg - m).sum(-1), torch.where(inside, gold, 0)]),
                model)
            lse = m[..., 0] + torch.log(both[0])
            gold = both[1]
        total = total + (lse - gold).sum()
        ztotal = ztotal + lse.square().sum()
    n_tok = b * s
    if rules is not None:
        batch = rules.comm(rules.batch)
        total, ztotal = sharding.psum(torch.stack([total, ztotal]), batch)
        n_tok *= batch.size
    return total / n_tok + z_loss * ztotal / n_tok


def loss_fn(params: dict, batch: dict, cfg: LMConfig, rules=None,
            aux_weight: float = 0.01, *, batch_size: int | None = None):
    """(CE + ``aux_weight`` · MoE balance loss, {"ce", "aux"}) of one batch
    of ``tokens`` and next-token ``labels`` (B, S).  With ``rules``:
    the rank's ``param_specs`` slices and the rank's rows of a global
    batch of ``batch_size`` rows (``rules.batch_cut``, as
    ``TokenPipeline(rules=)`` places them; by default a batch cut over
    every batch axis); the loss is the global one, the same on every rank
    (vocab-parallel ``chunked_ce``).  Rows held by ``copies`` ranks (a
    batch that does not divide over every batch axis) are summed once a
    copy and divided by the copies too: the global mean, and each copy's
    gradient its share of the rows' gradient, which the sums over the
    batch axes (``sync_grads``, ``gather_fsdp``'s backward) add up."""
    if rules is None:
        x, aux = forward_hidden(params, batch["tokens"], cfg)
        head = _head(params, cfg)
    else:
        x, aux = forward_hidden(params, batch["tokens"], cfg, rules,
                                local_rows=True, batch_size=batch_size)
        head = _Sharded(cfg, rules).head(params)
    ce = chunked_ce(x, head, batch["labels"], cfg.vocab, rules=rules)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: LMConfig, rules=None, *, lr=3e-4,
                    batch_size: int | None = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss's gradient over every leaf (attention's through K7b), then one
    AdamW step with the reference's defaults.  ``lr`` is a float or a
    schedule.  With ``rules`` (every rank calls it, on its slices and its
    rows of a global batch of ``batch_size`` rows, ``loss_fn``'s; the
    optimiser state mirrors the params' slices): the gradient
    summed over the batch axes where a leaf is replicated over them
    (``sharding.sync_grads``), clipped by the global norm over every
    rank's leaves, and the update elementwise on the rank's slices."""
    specs = param_specs(cfg, rules) if rules is not None else None

    def train_step(params, opt_state, batch):
        (loss, parts), grads = value_and_grad(loss_fn, params, batch, cfg,
                                              rules, batch_size=batch_size)
        if rules is not None:
            grads = sharding.sync_grads(grads, specs, rules)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             lr=lr, rules=rules, specs=specs)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


# --------------------------------------------------------------------------
# Serving: prefill + decode over a KV cache
# --------------------------------------------------------------------------

@torch.inference_mode()
def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda", rules=None) -> dict:
    """Zero KV cache in the reference's (L, B, KV, S, hd) layout, bf16;
    with ``rules`` the rank's shard of it (``cache_specs``)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.d_head)
    if rules is not None:
        spec = cache_specs(cfg, rules, batch, max_seq)["k"]
        shape = tuple(n // rules.axis_size(e) if e is not None else n
                      for n, e in zip(shape, spec))
    return {"k": torch.zeros(shape, dtype=layers.COMPUTE_DTYPE,
                             device=device),
            "v": torch.zeros(shape, dtype=layers.COMPUTE_DTYPE,
                             device=device)}


def make_prefill_step(cfg: LMConfig, max_seq: int, rules=None
                      ) -> Callable:
    """Prefill: (params, tokens (B, S)) -> (the last position's logits
    (B, Vp), a KV cache of ``max_seq`` filled at [0, S)).  K and v are
    computed once a layer, for attention and for the cache.  With
    ``rules``: the rank's cache shard, the whole logits."""
    plan = _plan(cfg, rules)

    @torch.inference_mode()
    def prefill_step(params, tokens):
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq "
                             f"{max_seq}")
        cache = init_cache(cfg, b, max_seq, tokens.device, rules)
        x = plan.embed(params, tokens)
        positions = torch.arange(s, device=tokens.device)[None]
        for i, lp in enumerate(_layer_params(params, cfg)):
            lp = plan.layer(lp)
            x, k, v = plan.attention(x, lp, positions)
            x, _ = plan.mlp(x, lp, b, want_aux=False)
            plan.store(cache, i, k, v, max_seq)
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        # Serving prefill only needs the last position's logits.
        return plan.logits(params, x[:, -1, :], b, mask=False), cache

    return prefill_step


def make_decode_step(cfg: LMConfig, max_seq: int, rules=None
                     ) -> Callable:
    """One decode step: (params, cache, tokens (B, 1), pos) -> (logits
    (B, Vp), cache).  Every row writes its K/V at ``pos`` (one global
    position, as the reference) and attends to cache positions <= pos
    through a float32 masked softmax; the cache is updated in place.

    ``pos`` is a Python int (checked against ``max_seq`` here) or a 0-dim
    int64 tensor on the cache's device, the form a captured step reads:
    the K/V row is then written by ``index_copy_`` at the device index,
    the counterpart of the reference's ``dynamic_update_slice``, and the
    caller, which knows the position as an int, checks its range.  Both
    forms give the same bits.  With ``rules``: the rank's cache shard,
    the whole logits (see ``_Sharded.decode_step``)."""
    if rules is not None:
        return _Sharded(cfg, rules).decode_step(max_seq)
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


# --------------------------------------------------------------------------
# Layouts: the hooks of the shared forward and prefill loops
# --------------------------------------------------------------------------

class _OneDevice:
    """The one-device layout: each hook of ``forward_hidden``'s and the
    prefill's loops is the plain op."""

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg

    def embed(self, params, tokens):
        return _embed(params, tokens)

    def layer(self, lp):
        return lp

    def attention(self, x, lp, positions):
        return _attention(x, lp, self.cfg, positions)

    def mlp(self, x, lp, batch: int, want_aux: bool = True):
        return _mlp_or_moe(x, lp, self.cfg, want_aux=want_aux)

    def store(self, cache, i, k, v, max_seq: int):
        s = k.shape[1]
        cache["k"][i, :, :, :s] = k.transpose(1, 2)
        cache["v"][i, :, :, :s] = v.transpose(1, 2)

    def logits(self, params, x, batch: int, mask: bool = True):
        lg = x @ _head(params, self.cfg)
        return _mask_pad_vocab(lg, self.cfg) if mask else lg


def _plan(cfg: LMConfig, rules, local_rows: bool = False):
    return (_OneDevice(cfg) if rules is None
            else _Sharded(cfg, rules, local_rows))


def _axes_of(spec) -> tuple[str, ...]:
    if spec is None:
        return ()
    return (spec,) if isinstance(spec, str) else tuple(spec)


class _Sharded(_OneDevice):
    """One rank's part of the reference's partitioned program, its
    collectives written out: the hooks of the shared loops (serving and,
    under autograd, the train step's forward) and the decode step.
    Parameters are the rank's ``param_specs`` slices; the leaves cut over
    ``fsdp`` are all-gathered a layer at a time where they are used, in
    one flat collective (``sharding.gather_fsdp``).  The residual stream
    is the rank's batch rows (``batch_spec``), whole over ``model``.

    * Attention: with ``n_heads % tp == 0`` the Q heads are cut over
      ``model`` (``wq`` column-parallel, ``wo`` row-parallel); K/V are
      the rank's own KV heads when ``n_kv_heads % tp == 0``, else whole
      on every rank, each rank taking the KV heads its Q heads read.
      Otherwise attention runs whole on every rank (the reference cuts
      Q's sequence there instead: the same function).  K7 runs on the
      rank's heads.
    * Dense MLP: ``d_ff`` cut over ``model`` when it divides (column,
      then row); else whole.  A row-parallel product sums the ranks'
      float32 products and rounds once (``layers.row_parallel``).
    * MoE: ``moe_apply`` expert-parallel, the tokens cut as
      ``tokens_spec(B·S)`` (``tokens_spec(B)`` at decode) says.  The
      serving steps read no balance loss, so they leave out its
      reduction over the shards.
    * Vocab: the embedding is looked up masked on the rank's rows and
      summed over ``model``; the head's logits are all-gathered over the
      vocab shards and the batch axes, so every rank holds them whole
      (the train step's CE stays on the rank's columns: ``chunked_ce``).
    * Cache: sequence-sharded over ``model`` (``cache_specs``).  Prefill
      moves each layer's head-sharded K/V to the cache's sequence chunks
      with one ``all_to_all``.  Decode writes the new K/V row on the rank
      that owns ``pos`` (a fixed-shape masked write that reads nothing on
      the host), takes ``flash_decode`` partials over the rank's chunk and
      combines them over ``model`` with two reductions.
    * Gradients: every collective of the forward is one of
      ``distributed.sharding``'s differentiable ops, each with the
      transpose backward: an FSDP gather reduce-scatters its cotangent,
      the normed input of a column-parallel product (and ``q_norm`` /
      ``k_norm``, read on the rank's heads) passes through
      ``copy_to_model``, a row-parallel sum and the embedding's sum pass
      their cotangent through, a weight gathered for work run whole on
      every rank takes back its own block.
    * Batch: the rank's rows are ``rules.batch_cut(B)``'s (whole on the
      ranks of the batch axes ``batch_spec`` leaves out).  Where the MoE's
      ``tokens_spec`` cuts the tokens over other batch axes than the rows,
      they are recut (gathered over the rows' axes, cut over the tokens'
      ones, and back), each gather a ``gather_fsdp``: the ranks read
      different parts of it, so its backward sums their cotangents.
    """

    def __init__(self, cfg: LMConfig, rules, local_rows: bool = False):
        super().__init__(cfg)
        self.rules = rules
        self.local_rows = local_rows
        self.specs = param_specs(cfg, rules)
        self.tp = rules.tp
        self.model = rules.comm(rules.model)
        self.fsdp = rules.comm(rules.fsdp)
        self.mi = self.model.index
        h, kv = cfg.n_heads, cfg.n_kv_heads
        self.tp_heads = self.tp > 1 and h % self.tp == 0
        self.kv_sharded = self.tp_heads and kv % self.tp == 0
        self.hq = h // self.tp if self.tp_heads else h
        self.kv_sel = None         # KV heads this rank's Q heads read
        if self.tp_heads and not self.kv_sharded:
            # The rank's q heads share one KV head when they fit in its
            # group; else each gets its own copy (G = 1).
            g, lo = h // kv, self.mi * self.hq
            self.kv_sel = torch.tensor(
                [lo // g] if g % self.hq == 0
                else [(lo + j) // g for j in range(self.hq)],
                device=rules.device)
        lay = self.specs["layers"]
        self.wo_rows = lay["wo"][1] is not None and self.tp > 1
        self.ff_cols = (not cfg.moe and lay["w_up"][2] is not None
                        and self.tp > 1)
        self.vocab_sharded = self.specs["embed"][0] is not None \
            and self.tp > 1

    # ---- layouts ------------------------------------------------------------
    def _fsdp(self, ts, specs):
        """The leaves ``ts`` whole over ``fsdp``: each leaf's dim that its
        spec cuts over it gathered, all in one flat collective."""
        dims = [next((d for d, e in enumerate(spec)
                      if e == self.rules.fsdp), None) for spec in specs]
        return sharding.gather_fsdp(ts, dims, self.fsdp)

    def _batch_axes(self, b: int) -> tuple[str, ...]:
        return _axes_of(self.rules.batch_spec(b))

    def _cut(self, t, b: int):
        """The rank's block of ``t``'s first dim as the rows of a batch
        of ``b`` are cut (``rules.batch_cut``)."""
        return self.rules.batch_cut(b).take(t)

    def _gather(self, t, axes):
        return sharding.gather_fsdp([t], [0], self.rules.comm(axes))[0]

    def _col_in(self, h):
        return sharding.copy_to_model(h, self.model)

    def _row_parallel(self, a, w):
        return layers.row_parallel(a, w, self.model)

    def _out_proj(self, o, lp, whole_heads: bool):
        """o (..., heads·hd) @ wo: the rank's rows of wo against its
        columns of o, summed over ``model``."""
        if not self.wo_rows:
            return o @ lp["wo"].to(layers.COMPUTE_DTYPE)
        if whole_heads or not self.tp_heads:
            o = sharding.split_model(o, self.model, -1)
        return self._row_parallel(o, lp["wo"])

    def _experts(self, tok, lp, n_tokens: int, b: int, want_aux: bool):
        """The EP MoE of the rank's tokens (its batch rows' ``tok``)."""
        cfg, rules = self.cfg, self.rules
        taxes = _axes_of(rules.tokens_spec(n_tokens))
        want = tuple(a for a in taxes if a != rules.model)
        have = self._batch_axes(b)
        if want != have:         # recut the tokens as token_axes says
            tok = self._cut(self._gather(tok, have), n_tokens)
        out, aux = moe_lib.moe_apply(
            tok, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.mlp_act,
            rules=rules, token_axes=taxes, want_aux=want_aux)
        if want != have:
            out = self._cut(self._gather(out, want), b)
        return out, aux

    # ---- hooks --------------------------------------------------------------
    def embed(self, params, tokens):
        tok = (tokens if self.local_rows
               else self._cut(tokens, tokens.shape[0]))
        table = self._fsdp([params["embed"]], [self.specs["embed"]])[0]
        if not self.vocab_sharded:
            return table[tok].to(layers.COMPUTE_DTYPE)
        vl = table.shape[0]
        idx = tok - self.mi * vl
        inside = (idx >= 0) & (idx < vl)
        e = torch.where(inside[..., None], table[idx.clamp(0, vl - 1)], 0)
        return sharding.reduce_from_model(e.to(layers.COMPUTE_DTYPE),
                                          self.model)

    def head(self, params):
        """The rank's vocab columns of the head, (D, Vp / tp) in bf16,
        whole over ``fsdp``."""
        if self.cfg.tie_embeddings:
            head = self._fsdp([params["embed"]], [self.specs["embed"]])[0].T
        else:
            head = self._fsdp([params["lm_head"]],
                              [self.specs["lm_head"]])[0]
        return head.to(layers.COMPUTE_DTYPE)

    def layer(self, lp):
        """Layer leaves as the rank uses them: whole over ``fsdp``, wq / wk
        / wv whole over ``model`` where the rank reads all their heads
        (their columns gathered), and the q / k norm scales, read on the
        rank's heads, through ``copy_to_model``."""
        lay = self.specs["layers"]
        names = list(lp)
        lp = dict(zip(names, self._fsdp(
            [lp[n] for n in names],
            [P(*list(lay[n])[1:]) for n in names])))
        gathered = [name for name, keep in (
            ("wq", self.tp_heads), ("wk", self.kv_sharded),
            ("wv", self.kv_sharded))
            if not keep and lay[name][2] is not None]
        if self.tp_heads:
            # Each rank reads the KV heads of its own q heads: its
            # cotangent is its part of the gathered leaves' gradient.
            got = sharding.gather_fsdp([lp[n] for n in gathered],
                                       [-1] * len(gathered), self.model)
            lp.update(zip(gathered, got))
            for name in ("q_norm", "k_norm"):
                if name in lp:
                    lp[name] = self._col_in(lp[name])
        else:
            for name in gathered:
                lp[name] = sharding.gather_model(lp[name], self.model, -1)
        return lp

    def attention(self, x, lp, positions):
        return _attention(x, lp, self.cfg, positions, kv_index=self.kv_sel,
                          out_proj=lambda o, lp: self._out_proj(o, lp,
                                                                False),
                          col_in=self._col_in if self.tp_heads else None)

    def mlp(self, x, lp, batch: int, want_aux: bool = True):
        n_tokens = batch * (x.shape[1] if x.dim() == 3 else 1)
        return _mlp_or_moe(
            x, lp, self.cfg,
            down=self._row_parallel if self.ff_cols else None,
            experts=lambda tok, lp: self._experts(tok, lp, n_tokens, batch,
                                                  want_aux),
            col_in=self._col_in if self.ff_cols else None)

    def _seq_chunk(self, max_seq: int) -> int:
        """Cache positions a rank holds: max_seq / tp, or all of them
        when tp does not divide max_seq (the cache stays whole)."""
        if self.tp > 1 and max_seq % self.tp == 0:
            return max_seq // self.tp
        return max_seq

    def store(self, cache, i, k, v, max_seq: int):
        """(B, S, kv heads here, hd) K and V into the rank's cache chunk,
        (B, KV, chunk, hd): one all_to_all from heads to sequence chunks
        when the KV heads are cut over ``model``."""
        kv = torch.stack([k, v]).transpose(2, 3)        # (2, B, kvx, S, hd)
        kv = torch.nn.functional.pad(kv, (0, 0, 0, max_seq - kv.shape[3]))
        chunk = self._seq_chunk(max_seq)
        if self.kv_sharded:
            kv = (self.model.all_to_all(kv, 3, 2) if chunk < max_seq
                  else self.model.all_gather(kv, axis=2))
        elif chunk < max_seq:
            kv = kv[:, :, :, self.mi * chunk:(self.mi + 1) * chunk]
        cache["k"][i] = kv[0]
        cache["v"][i] = kv[1]

    def logits(self, params, x, batch: int, mask: bool = True):
        """Whole (batch, ..., Vp) logits of the rank's rows x on every
        rank; padded vocab columns masked unless ``mask=False`` (the
        prefill's, which the reference leaves unmasked)."""
        cfg = self.cfg
        lg = x @ self.head(params)
        if self.vocab_sharded:
            lg = self.model.all_gather(lg, axis=-1)
        if mask:
            lg = _mask_pad_vocab(lg, cfg)
        return self.rules.comm(self._batch_axes(batch)).all_gather(lg,
                                                                   axis=0)

    # ---- decode -------------------------------------------------------------
    def _decode_heads(self, q, k, v):
        """One token's q (B, 1, heads here, hd), k, v (B, 1, kv heads
        here, hd) -> whole q (B, H, hd), k, v (B, KV, hd) on every rank:
        one all-gather of what the rank computed."""
        cfg = self.cfg
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        if self.kv_sharded:
            hq, kvl = q.shape[1], k.shape[1]
            g = self.model.all_gather(torch.cat([q, k, v], 1)[:, None], 1)
            return (g[:, :, :hq].reshape(q.shape[0], cfg.n_heads, -1),
                    g[:, :, hq:hq + kvl].reshape(k.shape[0],
                                                 cfg.n_kv_heads, -1),
                    g[:, :, hq + kvl:].reshape(v.shape[0],
                                               cfg.n_kv_heads, -1))
        if self.tp_heads:
            q = self.model.all_gather(q, axis=1)
        return q, k, v

    def decode_step(self, max_seq: int) -> Callable:
        cfg = self.cfg
        h, hd = cfg.n_heads, cfg.d_head
        chunk = self._seq_chunk(max_seq)
        start = self.mi * chunk if chunk < max_seq else 0

        @torch.inference_mode()
        def decode_step(params, cache, tokens, pos):
            if not torch.is_tensor(pos) and not 0 <= pos < max_seq:
                raise ValueError(f"decode position {pos} outside [0, "
                                 f"{max_seq})")
            b = tokens.shape[0]
            posv = torch.as_tensor(pos, device=tokens.device).reshape(())
            x = self.embed(params, tokens[:, 0])
            bl = x.shape[0]
            positions = posv.to(torch.int32).reshape(1, 1).expand(bl, 1)
            # The row at ``pos`` lives on one rank; every rank runs the
            # same fixed-shape write, a no-op where ``own`` is false.
            local = (posv - start).clamp(0, chunk - 1).reshape(1)
            own = (posv >= start) & (posv < start + chunk)
            for i, lp in enumerate(_layer_params(params, cfg)):
                lp = self.layer(lp)
                hn = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
                q, k, v = self._decode_heads(
                    *_qkv(hn[:, None], lp, cfg, positions))
                for name, new in (("k", k), ("v", v)):
                    c = cache[name][i]                  # (B, KV, chunk, hd)
                    old = c.index_select(2, local)
                    c.index_copy_(2, local,
                                  torch.where(own, new[:, :, None], old))
                # The chunk in flash_decode_local's (B, C, KV, hd) view.
                o, m, l = layers.flash_decode_local(
                    q, cache["k"][i].transpose(1, 2),
                    cache["v"][i].transpose(1, 2), posv + 1, start)
                if chunk < max_seq:
                    o = layers.combine_decode_partials(o, m, l, self.model)
                else:
                    o = o / l[..., None]
                o = o.reshape(bl, h * hd).to(x.dtype)
                x = x + self._out_proj(o, lp, True)
                x, _ = self.mlp(x, lp, b, want_aux=False)
            x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
            return self.logits(params, x, b), cache

        return decode_step
