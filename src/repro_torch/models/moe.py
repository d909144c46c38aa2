"""Mixture-of-Experts layer on one device.

Counterpart of ``repro.models.moe``: the local path of ``_moe_local`` with
the Switch/GShard capacity semantics.  Tokens are routed (softmax, then
top-k, renormalised), scattered into per-expert buckets of shape (E, C, D)
with ``C = ceil(T * k / E * capacity_factor)``, run through one batched
expert FFN, and combined back in token order weighted by their routing
weights.  An assignment past its expert's capacity is dropped: its token
keeps only its residual, as in the reference.  Padding experts (weights
padded to an expert-parallel degree) are masked out of the router's
logits, so they are never picked.

One card has no expert-parallel exchange: the reference's two
``all_to_all`` over the ``model`` axis are gone, and every expert is
local.  The routing and the capacity are the reference's, in the
reference's order of operations, so the same ids give the same kept
assignments and destinations.

Every step has a fixed shape and reads no tensor value on the host (no
boolean-mask indexing, no ``.item()``, ``nonzero`` or ``unique``): the
decode step that calls it is captured as one CUDA graph.  The bucket FFN
runs all E experts, empty buckets included, as the reference does.
"""

from __future__ import annotations

import math

import torch

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


def moe_apply(x, router, wg, wu, wd, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str = "swiglu"):
    """MoE over flat tokens x (T, D); expert weights (E_pad, D, F) etc.
    Returns (out (T, D) in x's dtype, the Switch load-balance loss, a
    float32 scalar)."""
    t, d = x.shape
    e_pad = wg.shape[0]
    cap = capacity(t, top_k, e_pad, capacity_factor)
    w, ids, probs = _route(x, router, n_real=n_experts, top_k=top_k)
    dest, keep = _dispatch_indices(ids, n_experts=e_pad, cap=cap)

    # Scatter: kept assignments land on distinct rows; every drop lands on
    # the extra last row, which is cut off.
    x_rep = x[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    buf = torch.zeros((e_pad * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, x_rep)
    y = _expert_ffn(buf[:-1].view(e_pad, cap, d), wg, wu, wd, act)

    back = y.reshape(e_pad * cap, d)
    picked = back.index_select(0, dest.clamp_max(e_pad * cap - 1))
    picked = torch.where(keep[:, None], picked, 0)
    out = (picked.view(t, top_k, d)
           * w.to(picked.dtype)[..., None]).sum(1)

    # Switch-style balance loss: E * sum_e f_e * p_e over all tokens.
    onehot = (ids[..., None] == torch.arange(e_pad, device=x.device)).float()
    f = onehot.sum(1).mean(0)
    aux = n_experts * (f * probs.mean(0)).sum()
    return out.to(x.dtype), aux


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
