"""Shared LM substrate: norms, RoPE, attention, dtype policy.

Counterpart of ``repro.models.layers`` for the LM's serving and training
paths.
Layouts are the reference's: q (B, S, H, hd), k and v (B, S, KV, hd).
Compute runs in bf16 (``COMPUTE_DTYPE``); norms, RoPE, softmax statistics
and attention accumulators run in float32.  Full-sequence attention goes
through K7 (``kernels.flash_attention``): on a CUDA tensor the kernel, on
a CPU tensor its plain version; under autograd its backward is K7b.  The reference's sharded decode helpers
(``flash_decode_local``, ``combine_decode_partials``) and its remat and
scan machinery have no use on one card and are not ported.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention

COMPUTE_DTYPE = torch.bfloat16


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S).  Rotates
    halves (not interleaved pairs) in float32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """GQA attention over the full sequence without the (S, S) scores:
    q (B, S, H, hd), k and v (B, S, KV, hd) with H = KV·G -> (B, S, H, hd)
    in q's dtype.  The chunks, cut to S, must divide S, as in the
    reference; they are K7's blocks.  Differentiable in q, k and v (the
    gradient through K7b, ``kernels.flash_attention.flash_attention_bwd``)."""
    s = q.shape[1]
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"chunked_attention: chunks ({q_chunk}, "
                         f"{kv_chunk}) must divide S = {s}")
    return flash_attention(q, k, v, causal, q_chunk, kv_chunk)


def reference_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Naive O(S²)-memory float32 oracle (tests only)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, s, kvh, g, hd) / math.sqrt(hd)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        sc = torch.where(mask, sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)
