"""Shared model substrate: norms, RoPE, attention, activations, the
bilinear resize, initialisers, dtype policy.

Counterpart of ``repro.models.layers`` for the LM's and the vision and
diffusion zoo's serving and training paths.
Layouts are the reference's: q (B, S, H, hd), k and v (B, S, KV, hd);
images NHWC.  Compute runs in bf16 (``COMPUTE_DTYPE``); norms, RoPE,
softmax statistics and attention accumulators run in float32.
Full-sequence attention goes through K7 (``kernels.flash_attention``): on
a CUDA tensor the kernel, on a CPU tensor its plain version; under
autograd its backward is K7b.  Layer stacks run through
:func:`scan_layers`, the reference's per-layer remat (activation
checkpointing) under ``REMAT_POLICIES``: one card's memory is what sets
the batch a train step holds.  Flash decode over a sequence-sharded KV
cache is :func:`flash_decode_local` (one rank's partials over its chunk)
and :func:`combine_decode_partials` (two small reductions over the mesh
axis, never a gather of the cache).
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.utils.flop_counter import register_flop_formula

from repro_torch import tree
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


# --------------------------------------------------------------------------
# Flash decode — sequence-parallel attention over a sharded KV cache
# --------------------------------------------------------------------------

def flash_decode_local(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, valid_len, chunk_start):
    """Partial attention of one query over a *local* KV-cache chunk, the
    reference's: q (B, H, hd); k/v_cache (B, C, KV, hd) (the sharded
    decode step passes its (B, KV, C, hd) chunk transposed: a view);
    ``valid_len`` the cache's valid length and ``chunk_start`` the chunk's
    global offset (ints or 0-dim tensors).  Returns float32 partials (o
    (B, H, hd) unnormalised, m (B, H), l (B, H)) to combine across
    shards; positions at or past ``valid_len`` are masked with -1e30."""
    b, c, kvh, hd = k_cache.shape
    h = q.shape[1]
    qf = q.float().reshape(b, kvh, h // kvh, hd) / math.sqrt(hd)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.transpose(1, 2).float())
    pos = chunk_start + torch.arange(c, device=q.device)
    s = torch.where(pos < valid_len, s, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.transpose(1, 2).float())
    return o.reshape(b, h, hd), m.reshape(b, h), p.sum(-1).reshape(b, h)


def combine_decode_partials(o: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, group) -> torch.Tensor:
    """Combine per-shard flash-decode partials over ``group`` (a
    :class:`~repro_torch.distributed.sharding.Collective`): o (..., hd)
    unnormalised, m and l (...).  Two small reductions — the max, then
    one sum of l and o rescaled to it — instead of a gather of the cache;
    l is floored at 1e-30 as in the reference."""
    m_glob = group.pmax(m)
    corr = torch.exp(m - m_glob)
    both = group.psum(torch.cat([(l * corr)[..., None],
                                 o * corr[..., None]], dim=-1))
    return both[..., 1:] / both[..., :1].clamp_min(1e-30)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the last dim in float32, cast back to x's dtype; a
    ``None`` scale is the reference's scale of ones (a product by 1.0 is
    exact), a ``None`` bias adds nothing."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation (DiT): x * (1 + scale) + shift, broadcast over the
    sequence."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def gelu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """GELU, the tanh form (``jax.nn.gelu(approximate=True)``).

    By default one ``F.gelu`` call, rounded once: within a step of x's
    dtype of the reference.  ``exact`` evaluates the reference's formula
    op by op in x's dtype, its constants rounded to that dtype first, as
    jax does; in bf16 that gives the reference's bits.  The binary
    variants need it: they binarise GELU's output, and below about -3.3
    the reference's bf16 tanh rounds to -1, so its GELU is -0, whose STE
    sign is +1, where a single rounding keeps a tiny negative value (sign
    -1)."""
    if not exact:
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype).item()
    k = torch.tensor(0.044715, dtype=x.dtype).item()
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def silu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """SiLU, x·sigmoid(x).  By default one ``F.silu`` call; ``exact``
    evaluates the reference's x · 1 / (1 + exp(-x)) op by op in x's dtype,
    which gives its bf16 bits (a binary variant binarises what follows a
    SiLU, where a step's difference flips the signs of values near 0)."""
    if not exact:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def resize_grid(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) resized bilinearly to (B, height, width, C), as
    ``jax.image.resize(..., "bilinear")`` does: half-pixel centres, and
    past the edges the nearest row (jax drops the outside taps and
    renormalises the rest, which gives the same value); shrinking
    antialiases, as jax does.  The zoo only enlarges position tables."""
    _, h, w, _ = img.shape
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(height, width),
                        mode="bilinear", align_corners=False,
                        antialias=height < h or width < w)
    return out.permute(0, 2, 3, 1).contiguous()


# --------------------------------------------------------------------------
# The row-parallel product
# --------------------------------------------------------------------------

# The collectives ``row_parallel`` has been handed, by the handle its op
# takes (an op's schema holds no Python object); weak, so that a mesh's
# collectives go when their last user does.
_ROW_COMMS: "weakref.WeakValueDictionary[int, object]" = \
    weakref.WeakValueDictionary()


@torch.library.custom_op("repro_torch::row_parallel", mutates_args=())
def _row_parallel_op(a: torch.Tensor, w: torch.Tensor, comm: int,
                     lead: int) -> torch.Tensor:
    w = w.to(COMPUTE_DTYPE)
    wide = torch.promote_types(a.dtype, torch.float32)
    if a.is_cuda and a.dtype != wide:
        p = torch.mm(a, w, out_dtype=torch.float32)
    else:
        p = a.to(wide) @ w.to(wide)
    return _row_sum(p, comm, lead)


def _row_sum(p: torch.Tensor, comm: int, lead: int) -> torch.Tensor:
    """The ranks' float32 products summed over ``_ROW_COMMS[comm]`` (with
    ``lead``, reduce-scattered: the (lead, rows, D) sums' block of this
    rank along rows), rounded to bf16 once."""
    group = _ROW_COMMS[comm]
    if not lead:
        return group.psum(p).to(COMPUTE_DTYPE)
    p = p.view(lead, group.size, -1, p.shape[-1]).movedim(1, 0)
    return group.reduce_scatter(p).reshape(-1, p.shape[-1]).to(
        COMPUTE_DTYPE)


@_row_parallel_op.register_fake
def _row_parallel_fake(a, w, comm, lead):
    """The product's shape, and the same collective on it, so that a
    traced step hands the group what a run would (fake process groups
    record it, ``Collective`` counts it)."""
    wide = torch.promote_types(a.dtype, torch.float32)
    return _row_sum(a.new_empty((a.shape[0], w.shape[1]), dtype=wide),
                    comm, lead)


@register_flop_formula(torch.ops.repro_torch.row_parallel)
def _row_parallel_flops(a_shape, w_shape, *args, **kwargs) -> int:
    """The rank's product, 2·M·K·N (the sum over the ranks is not
    counted)."""
    return 2 * a_shape[0] * a_shape[1] * w_shape[1]


def _row_parallel_setup(ctx, inputs, output):
    a, w, comm, lead = inputs
    ctx.save_for_backward(a, w)
    ctx.comm, ctx.lead = comm, lead


def _row_parallel_backward(ctx, g):
    a, w = ctx.saved_tensors
    g = g.to(COMPUTE_DTYPE)
    if ctx.lead:          # the scatter's transpose: the cotangent gathered
        g = _ROW_COMMS[ctx.comm].all_gather(
            g.reshape(ctx.lead, -1, g.shape[-1]).contiguous(), axis=1)
        g = g.reshape(-1, g.shape[-1])
    return g @ w.to(COMPUTE_DTYPE).T, (a.T @ g).to(w.dtype), None, None


_row_parallel_op.register_autograd(_row_parallel_backward,
                                   setup_context=_row_parallel_setup)


def row_parallel(a: torch.Tensor, w: torch.Tensor, comm,
                 scatter_axis: int | None = None) -> torch.Tensor:
    """``a @ w`` (to bf16) with w's rows, a's columns, cut over ``comm``'s
    ranks: each rank's bf16 product accumulated and kept in float32,
    summed over the ranks, and rounded to bf16 once, as the one-device
    product rounds its float32 accumulation (the CPU's matmul has no
    bf16-in, float32-out form, so there the operands are widened: bf16
    products are exact in float32, the same function; float32 operands,
    the float32-compute check, take the plain float32 product).  The
    backward is the two bf16 products of the cotangent, which every rank
    holds whole, as autograd of the one-device product gives them (and no
    collective: the sum's transpose on a cotangent replicated over the
    ranks).  One op (``repro_torch::row_parallel``), so that the "dots"
    policy keeps its output and a layer's recompute makes no second sum.

    ``scatter_axis``: the sum reduce-scattered instead, each rank keeping
    its block of ``a``'s dim ``scatter_axis`` (a Megatron-SP block
    boundary: ``sharding.reduce_scatter_model`` fused with the product);
    the backward then all-gathers the cotangent along it first."""
    _ROW_COMMS[id(comm)] = comm
    lead = 0
    shape = list(a.shape[:-1])
    if scatter_axis is not None and comm.size > 1:
        axis = scatter_axis % a.dim()
        if shape[axis] % comm.size:
            raise ValueError(f"row_parallel: dim {axis} of "
                             f"{tuple(a.shape)} does not split over "
                             f"{comm.size}")
        lead = math.prod(shape[:axis])
        shape[axis] //= comm.size
    a2 = a.reshape(-1, a.shape[-1])
    return _row_parallel_op(a2, w, id(comm), lead).reshape(*shape, -1)


# --------------------------------------------------------------------------
# Layer stacking with per-layer remat
# --------------------------------------------------------------------------

#: The matrix products "dots" keeps: whatever ``@``, ``einsum`` and
#: ``F.linear`` lower to, and the row-parallel product (its sum over the
#: mesh included).
DOT_OPS = frozenset({torch.ops.aten.mm, torch.ops.aten.addmm,
                     torch.ops.aten.bmm, torch.ops.aten.baddbmm,
                     torch.ops.repro_torch.row_parallel})


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the output of every
    matrix product, recompute everything else."""
    policy = torch.utils.checkpoint.CheckpointPolicy
    return (policy.MUST_SAVE if op.overloadpacket in DOT_OPS
            else policy.PREFER_RECOMPUTE)


def _dots_saveable():
    """The forward and recompute contexts of the "dots" policy, new for each
    checkpointed call.  Raises where this torch has no selective
    checkpoint, rather than recompute every product ("nothing")."""
    make = getattr(torch.utils.checkpoint,
                   "create_selective_checkpoint_contexts", None)
    if make is None:
        raise RuntimeError(
            f"remat_policy 'dots' needs torch.utils.checkpoint."
            f"create_selective_checkpoint_contexts, which torch "
            f"{torch.__version__} lacks")
    return make(_dots_policy)


#: The reference's checkpoint policies, each as the ``context_fn`` of
#: ``torch.utils.checkpoint.checkpoint``.
REMAT_POLICIES = {
    # recompute everything in the backward: a layer keeps only its inputs,
    # at the cost of one more forward
    "nothing": torch.utils.checkpoint.noop_context_fn,
    # keep the matrix products' outputs, recompute the elementwise ops
    "dots": _dots_saveable,
}


def scan_layers(body, carry, layer_params, *, n_layers: int,
                remat: bool = True, remat_policy: str = "nothing"):
    """``carry, y = body(carry, params of layer i)`` for i < ``n_layers``
    over ``layer_params``, a tree of tensors stacked on a leading layer
    dim; returns (carry, the ys stacked leaf by leaf, or None when the body
    returns None).  The reference's ``scan_layers`` on its unrolled path
    (the port has no scan).

    With ``remat`` and grad mode on, each layer runs through
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant, which
    ``torch.autograd.grad`` needs) under ``REMAT_POLICIES[remat_policy]``:
    the backward recomputes what the policy did not keep, so the loss and
    the gradients are those of the plain loop.  K7's op is not among
    ``DOT_OPS``, so its forward runs again in the backward under either
    policy (a second launch a layer); so does the reference's attention,
    which its ``chunked_attention`` checkpoints on its own.  The recompute calls ``body`` again in the
    backward, so it must read nothing that changes after the call (bind
    a loop variable as a default argument) and draw no random numbers:
    the checkpoint does not save and restore the RNG state, which no
    layer body of the port reads.  With grad mode off (the
    serving forwards under ``torch.inference_mode``) the body is called
    directly."""
    context_fn = REMAT_POLICIES[remat_policy]
    remat = remat and torch.is_grad_enabled()
    ys = []
    for i in range(n_layers):
        params_i = tree.tree_map(lambda t: t[i], layer_params)
        if remat:
            carry, y = torch.utils.checkpoint.checkpoint(
                body, carry, params_i, use_reentrant=False,
                context_fn=context_fn, preserve_rng_state=False)
        else:
            carry, y = body(carry, params_i)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree.tree_map(lambda *a: torch.stack(a), *ys)


def draw(shape, std: float, generator: torch.Generator,
         device: torch.device) -> torch.Tensor:
    """N(0, std²) float32 of ``shape`` from ``generator`` on ``device``."""
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def hwio_to_oihw(a: torch.Tensor) -> torch.Tensor:
    """A conv kernel (KH, KW, I, O), or a stack (L, KH, KW, I, O), in
    PyTorch's (O, I, KH, KW) layout (a depthwise (K, K, 1, C) becomes
    (C, 1, K, K)), contiguous."""
    perm = (3, 2, 0, 1) if a.ndim == 4 else (0, 4, 3, 1, 2)
    return a.permute(*perm).contiguous()


def oihw_to_hwio(a: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`hwio_to_oihw`."""
    perm = (2, 3, 1, 0) if a.ndim == 4 else (0, 3, 4, 2, 1)
    return a.permute(*perm).contiguous()


def store(tree, dtype: torch.dtype, keep32: frozenset = frozenset(),
          name: str = ""):
    """A parameter tree with every leaf in ``dtype`` but those whose name
    (their last dict key) is in ``keep32``, which stay as they are."""
    if isinstance(tree, dict):
        return {k: store(v, dtype, keep32, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(store(v, dtype, keep32, name) for v in tree)
    return tree if name in keep32 else tree.to(dtype)


def tree_from_numpy(tree, device: torch.device, dtype: torch.dtype,
                    conv: frozenset = frozenset(),
                    keep32: frozenset = frozenset()):
    """A parameter tree of numpy arrays (the reference's pytree through
    ``np.asarray``) as tensors on ``device``: a leaf whose name (its last
    dict key) is in ``conv`` goes from HWIO to OIHW, one in ``keep32``
    stays float32, every other one is stored in ``dtype``.  The leaves are
    copied (the reference's arrays are read-only)."""
    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, name) for v in t)
        x = torch.from_numpy(np.array(t, dtype=np.float32))
        if name in conv:
            x = hwio_to_oihw(x)
        return x.to(device, torch.float32 if name in keep32
                    else dtype).contiguous()
    return walk(tree, "")
