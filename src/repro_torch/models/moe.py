"""Mixture-of-Experts layer, on one device or expert-parallel over a mesh.

Counterpart of ``repro.models.moe``, with the Switch/GShard capacity
semantics.  Tokens are routed (softmax, then top-k, renormalised),
scattered into per-expert buckets of shape (E, C, D) with
``C = ceil(T_local * k / E * capacity_factor)``, run through one batched
expert FFN, and combined back in token order weighted by their routing
weights.  An assignment past its expert's capacity is dropped: its token
keeps only its residual, as in the reference.  Padding experts (weights
padded to an expert-parallel degree) are masked out of the router's
logits, so they are never picked.

With ``rules`` the layer is expert-parallel (EP) over the ``model`` axis,
the reference's ``_moe_local`` on each rank: route the rank's tokens
locally, scatter them into (E_pad, C, D) buckets, one ``all_to_all`` so
that each rank keeps its E_pad/ep experts and receives that bucket from
every peer, the bucket FFN on the local experts, the inverse
``all_to_all``, the weighted un-scatter; the balance loss is averaged
over every mesh axis (``want_aux=False`` leaves it out, with its
collective).  Capacity is per source shard: ``T_local`` is the
token count over ``token_axes``.  The port keeps the residual stream
whole over ``model``, so when ``token_axes`` holds ``model`` the layer
cuts its tokens over it itself and all-gathers the output back; when it
does not (decode: too few tokens) every model rank routes the same
tokens redundantly, as the reference does.  Without ``rules`` every
expert is local and nothing is exchanged.

Every step has a fixed shape and reads no tensor value on the host (no
boolean-mask indexing, no ``.item()``, ``nonzero`` or ``unique``): the
one-device decode step that calls it is captured as one CUDA graph.  The
bucket FFN runs every expert, empty buckets included, as the reference
does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding
from repro_torch.models import layers


def padded_experts(n_experts: int, ep: int) -> int:
    return -(-n_experts // ep) * ep


def capacity(tokens_local: int, top_k: int, n_experts_padded: int,
             factor: float) -> int:
    """Slots a bucket, in the reference's expression and order (a
    reordered one can round to another integer and change the drops)."""
    c = math.ceil(tokens_local * top_k / n_experts_padded * factor)
    return max(c, 1)


def _route(x, router, *, n_real: int, top_k: int):
    """x (T, D), router (D, E_pad) -> (weights (T, k) float32, ids (T, k)
    int64, probs (T, E_pad) float32); padding experts masked out."""
    logits = x.float() @ router.float()
    e_pad = router.shape[1]
    if e_pad != n_real:
        mask = torch.arange(e_pad, device=x.device) < n_real
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return w, ids, probs


def _dispatch_indices(ids, *, n_experts: int, cap: int):
    """Flat (T*k,) destinations ``expert*C + position`` and a keep mask.

    The position inside each expert's bucket is a token-major cumsum over
    the one-hot assignment matrix; an assignment at position >= C is
    dropped and goes to the sentinel ``E*C``.  Returns (dest (T*k,) int64,
    keep (T*k,) bool).  The one-hot is laid out (E, T*k), the reference's
    transposed, so that the cumsum runs along the contiguous dim in int32
    (a cumsum down the (T*k, E) columns, promoted to int64, took 12 ms of
    qwen3-moe-30b-a3b's 16 ms a prefill layer on the H100)."""
    flat = ids.reshape(-1)
    onehot = torch.arange(n_experts, device=ids.device)[:, None] == flat
    pos = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32) - 1
    pos_t = pos.gather(0, flat[None]).squeeze(0)
    keep = pos_t < cap
    dest = torch.where(keep, flat * cap + pos_t, n_experts * cap)
    return dest, keep


def _expert_ffn(xe, wg, wu, wd, act: str):
    """xe (E, C, D); weights (E, D, F), (E, D, F), (E, F, D) -> (E, C, D),
    the products in bf16 as the reference casts them."""
    cd = layers.COMPUTE_DTYPE
    xe = xe.to(cd)
    h_up = torch.bmm(xe, wu.to(cd))
    if act == "swiglu":
        h_gate = torch.bmm(xe, wg.to(cd))
        h = torch.nn.functional.silu(h_gate.float()).to(cd) * h_up
    elif act == "relu2":
        h = torch.relu(h_up).square()
    else:
        raise ValueError(act)
    return torch.bmm(h, wd.to(cd))


def _moe_body(x, router, wg, wu, wd, *, n_real: int, top_k: int,
              cap: int, act: str, ep=None):
    """Route x (T, D), scatter into (E_pad, C, D) buckets, run the expert
    FFN (over ``ep``'s two ``all_to_all`` when given, a
    :class:`~repro_torch.distributed.sharding.Collective` over the model
    axis; wg/wu/wd then hold the rank's experts), un-scatter.  Returns
    (out (T, D) in x's dtype, this shard's balance loss)."""
    t, d = x.shape
    e_pad = router.shape[1]
    w, ids, probs = _route(x, router, n_real=n_real, top_k=top_k)
    dest, keep = _dispatch_indices(ids, n_experts=e_pad, cap=cap)

    # Scatter: kept assignments land on distinct rows; every drop lands on
    # the extra last row, which is cut off.
    x_rep = x[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    buf = torch.zeros((e_pad * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, x_rep)
    buckets = buf[:-1].view(e_pad, cap, d)
    if ep is None:
        y = _expert_ffn(buckets, wg, wu, wd, act)
    else:
        # EP exchange: keep E_pad/ep experts, receive from all ep peers.
        recv = sharding.all_to_all(buckets, ep, 0, 1)  # (El, ep*C, D)
        y = sharding.all_to_all(_expert_ffn(recv, wg, wu, wd, act), ep, 1,
                                0)

    back = y.reshape(e_pad * cap, d)
    picked = back.index_select(0, dest.clamp_max(e_pad * cap - 1))
    picked = torch.where(keep[:, None], picked, 0)
    out = (picked.view(t, top_k, d)
           * w.to(picked.dtype)[..., None]).sum(1)

    # Switch-style balance loss: E * sum_e f_e * p_e over the tokens.
    onehot = (ids[..., None] == torch.arange(e_pad, device=x.device)).float()
    f = onehot.sum(1).mean(0)
    aux = n_real * (f * probs.mean(0)).sum()
    return out.to(x.dtype), aux


def _moe_local(x, router, wg, wu, wd, *, n_real: int, top_k: int,
               cap: int, ep, all_axes, act: str, copies: int = 1):
    """The per-shard EP body, the reference's ``_moe_local``: x (T_local,
    D) this shard's tokens, router (D, E_pad) whole, wg/wu/wd the rank's
    E_pad/ep experts; ``ep`` the collectives over the model axis,
    ``all_axes`` over every axis.  Returns (out (T_local, D), aux averaged
    over every shard; ``copies`` shards hold each value alike)."""
    out, aux = _moe_body(x, router, wg, wu, wd, n_real=n_real, top_k=top_k,
                         cap=cap, act=act, ep=ep)
    return out, sharding.pmean(aux, all_axes, copies)


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, share):
        ctx.share = share
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.share, None


def moe_apply(x, router, wg, wu, wd, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str = "swiglu", rules=None,
              token_axes=(), want_aux: bool = True):
    """MoE over flat tokens x (T, D).  Returns (out (T, D) in x's dtype,
    the Switch load-balance loss, a float32 scalar, or None where
    ``want_aux`` is false: the serving steps, which read none, so that a
    sharded layer makes no collective for it).

    Without ``rules``: one device, expert weights (E_pad, D, F) etc.
    With ``rules``: expert-parallel over ``rules.model``; x is this rank's
    rows of the tokens cut over the batch axes of ``token_axes`` (whole
    over ``model``), the expert weights the rank's E_pad/ep experts, and
    the output comes back in x's layout.  Differentiable (each rank's
    loss the global one): the tokens are cut over ``model`` by
    ``split_model`` and the output gathered by ``gather_model``; the
    router, read on the rank's tokens alone there, passes through
    ``copy_to_model``.  Where the tokens are not cut over ``model``,
    every model rank routes the same tokens, so each expert receives
    ``ep`` alike copies of its bucket: its weights take 1/ep of the
    summed cotangent, and the balance loss, alike on the model ranks,
    takes the share of one copy."""
    e_pad = router.shape[1]
    if rules is None:
        cap = capacity(x.shape[0], top_k, e_pad, capacity_factor)
        out, aux = _moe_body(x, router, wg, wu, wd, n_real=n_experts,
                             top_k=top_k, cap=cap, act=act)
        return out, aux if want_aux else None
    ep = rules.tp
    if e_pad % ep or wg.shape[0] * ep != e_pad:
        raise ValueError(f"{e_pad} experts over ep {ep}: the rank holds "
                         f"{wg.shape[0]}")
    token_axes = tuple(token_axes) if token_axes else ()
    split = rules.model in token_axes
    model = rules.comm(rules.model)
    if split:
        if x.shape[0] % ep:
            raise ValueError(f"{x.shape[0]} tokens do not split over "
                             f"{rules.model} ({ep})")
        x = sharding.split_model(x, model, 0)
        router = sharding.copy_to_model(router, model)
    elif ep > 1 and torch.is_grad_enabled():
        wg, wu, wd = (_ShareGrad.apply(w, 1.0 / ep) for w in (wg, wu, wd))
    cap = capacity(x.shape[0], top_k, e_pad, capacity_factor)
    if want_aux:
        out, aux = _moe_local(
            x, router, wg, wu, wd, n_real=n_experts, top_k=top_k, cap=cap,
            ep=model, all_axes=rules.comm(tuple(rules.mesh.axis_names)),
            act=act, copies=1 if split else ep)
    else:
        out, aux = _moe_body(x, router, wg, wu, wd, n_real=n_experts,
                             top_k=top_k, cap=cap, act=act, ep=model)[0], None
    if split:
        out = sharding.gather_model(out, model, 0)
    return out, aux


def moe_reference(x, router, wg, wu, wd, *, n_experts: int, top_k: int,
                  act: str = "swiglu"):
    """Dense oracle: every expert on every token, then the top-k combine.
    No capacity, no drops: ``moe_apply`` equals it when its capacity
    factor is high enough that nothing drops."""
    w, ids, _ = _route(x, router, n_real=n_experts, top_k=top_k)
    e_pad = wg.shape[0]
    all_out = _expert_ffn(x.expand(e_pad, *x.shape), wg, wu, wd,
                          act)                                 # (E, T, D)
    picked = torch.take_along_dim(all_out.transpose(0, 1), ids[..., None],
                                  dim=1)                       # (T, k, D)
    return (picked * w.to(picked.dtype)[..., None]).sum(1)
