"""K7: GQA attention with an online softmax (flash attention), and K7b, its
backward.

Port of ``repro.kernels.flash_attention.flash_attention`` (``_flash_fwd``,
``_kernel``, and the ``custom_vjp`` backward ``_bwd``); the forward's CUDA
kernel is ``csrc/flash_attention.cu``: a
warp-specialised Hopper kernel in which a producer warpgroup feeds a ring
of K/V tiles through TMA and two consumer warpgroups run both products on
``wgmma`` (bf16 in, float32 accumulation; bf16 inputs, head width 64 or
128: one template instantiation each; 72 and 80 run a padded 128 one on
zero-filled columns, see ``KERNEL_HEAD_DIMS``).
For q (B, Sq, H, hd) and k, v (B, Skv, KV, hd) with H = KV·G:

    out = softmax(q·kᵀ / sqrt(hd) [causal mask]) · v     in q's dtype

Scores, the running max and sum and the accumulator are float32; p is
rounded to v's dtype for the PV product, which accumulates in float32; the
output is divided by ``max(l, 1e-30)``.  Causal assumes Sq == Skv.  The
plain version keeps the reference's block contract: ``block_q``
(``block_k``), cut to Sq (Skv), must divide it.  The CUDA kernel tiles by
128 rows and keys and masks ragged tiles, so it ignores the blocks.  The
plain version also takes float32 and any head width (the CPU tests); on
the card the kernel takes bf16 only, the models' compute dtype, at their
head widths: 128 (minitron-8b, qwen3-moe-30b-a3b, command-r-35b), 64
(granite-moe-3b-a800m, lm-100m, ViT-L/16, DiT-L/2), 80 (ViT-H/14) and 72
(DiT-XL/2).

Gradients.  :func:`flash_attention` is differentiable: when grad mode is
on and q, k or v requires a gradient it runs through an autograd Function
whose forward also writes each row's log-sum-exp ``lse`` (B, H, Sq) and
whose backward is K7b (:func:`flash_attention_bwd`,
``csrc/flash_attention_bwd.cu``): dq, dk and dv of the same function, dk
and dv summed over each KV head's G q heads, in the inputs' dtypes.  The
reference recomputes through its jnp chunked attention there; K7b
recomputes p = exp(s - lse) tile by tile in one warp-specialised TMA /
``wgmma`` kernel (the FlashAttention-3 backward's shape) that computes
each product once and sums dq over the key tiles in a fixed order, so two
calls on the same inputs give the same bits.  Both kernels take their
Hopper helpers from ``csrc/hopper.cuh``.  Otherwise (serving, prefill,
the captured paths) the call launches the forward alone, with no ``lse``.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

NEG_INF = -1e30
#: Head widths the CUDA kernels take: 64 and 128 have an instantiation
#: each; 72 and 80 run a third, the 128-wide tiles padded: tensor maps of
#: their true width, whose columns past hd TMA fills with zeros (exact, at
#: 128/hd of the products' work), and hd as the row stride of the direct
#: stores.  Any other width raises on the card.
KERNEL_HEAD_DIMS = (64, 72, 80, 128)


def _check_shapes(q, k, v, causal: bool) -> None:
    """The layouts both versions take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, Sq, H, hd), k and v "
                         f"(B, Skv, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (H must be a multiple "
                         f"of KV)")
    if causal and sq != skv:
        raise ValueError(f"flash_attention: causal needs Sq == Skv, got "
                         f"{sq} and {skv}")


def _check_blocks(sq: int, skv: int, block_q: int, block_k: int
                  ) -> tuple[int, int]:
    """The reference's block contract; returns the blocks cut to the
    sequence lengths."""
    block_q, block_k = min(block_q, sq), min(block_k, skv)
    if sq % block_q or skv % block_k:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_k}) "
                         f"must divide (Sq, Skv) = ({sq}, {skv})")
    return block_q, block_k


def flash_attention_plain(q, k, v, causal: bool = True, block_q: int = 512,
                          block_k: int = 512, *, return_lse: bool = False):
    """The plain PyTorch version: ``_kernel``'s blocked online softmax with
    the same dtype steps, the q heads of each KV head taken together (no
    K/V copy per q head).  With ``return_lse`` it returns (out, lse), lse
    (B, H, Sq) float32 = m + log l of the scaled scores, as the kernel
    writes it for K7b."""
    _check_shapes(q, k, v, causal)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    block_q, block_k = _check_blocks(sq, skv, block_q, block_k)
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qr = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).float() * scale
    kr = k.permute(0, 2, 1, 3).float()                    # (B, KV, Skv, hd)
    vr = v.permute(0, 2, 1, 3)
    out = torch.empty((b, kvh, g, sq, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((b, kvh, g, sq), device=dev)
    for q_lo in range(0, sq, block_q):
        qi = qr[:, :, :, q_lo:q_lo + block_q]
        m = torch.full((b, kvh, g, block_q), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, block_q), device=dev)
        acc = torch.zeros((b, kvh, g, block_q, hd), device=dev)
        n_k = skv // block_k
        if causal:       # triangular: KV blocks up to this block's diagonal
            n_k = min(n_k, -(-(q_lo + block_q) // block_k))
        for ki in range(n_k):
            k_lo = ki * block_k
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi,
                             kr[:, :, k_lo:k_lo + block_k])
            if causal:
                q_pos = q_lo + torch.arange(block_q, device=dev)
                kv_pos = k_lo + torch.arange(block_k, device=dev)
                s = torch.where(q_pos[:, None] >= kv_pos[None, :], s,
                                NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            # p rounded to v's dtype; the products are exact in float32
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                              vr[:, :, k_lo:k_lo + block_k].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, :, q_lo:q_lo + block_q] = (
            acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        lse[:, :, :, q_lo:q_lo + block_q] = m + torch.log(l.clamp_min(1e-30))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    if return_lse:
        return out, lse.reshape(b, h, sq)
    return out


def flash_attention_fwd(q, k, v, causal: bool = True, block_q: int = 512,
                        block_k: int = 512, with_lse: bool = True):
    """K7's launch: (out, lse or None), the lse (B, H, Sq) float32 only
    ``with_lse``.  The plain version for CPU tensors, K7 for CUDA tensors
    (bf16, hd in ``KERNEL_HEAD_DIMS``) through the op
    ``repro_torch::flash_attention_fwd``; anything else raises."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, causal, block_q, block_k,
                                         return_lse=True)
        return flash_attention_plain(q, k, v, causal, block_q, block_k), None
    _check_shapes(q, k, v, causal)
    _check_kernel_contract(q)
    out, lse = _fwd_op(q, k, v, causal, block_q, block_k, with_lse)
    return out, (lse if with_lse else None)


# K7 and K7b are ops (``torch.library.custom_op``) so that a trace under
# ``FakeTensorMode`` gets their outputs' shapes from their fakes, never
# reaching the library or a ``data_ptr``, and ``FlopCounterMode`` counts
# them by the bound's formula.  On a CPU tensor an op runs the plain
# version (the wrappers call that directly, ``opcheck`` calls the op).

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            block_q: int, block_k: int, with_lse: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal, block_q, block_k,
                                         return_lse=True)
        return out.contiguous(), lse if with_lse else lse.new_empty(0)
    _check_shapes(q, k, v, causal)
    _check_kernel_operands(dict(q=q, k=k, v=v))
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq) if with_lse else 0, dtype=torch.float32,
                      device=q.device)
    lib = build.library()
    flash_attention.launches += 1
    build.check(lib.launch_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, sq, skv, h, kvh, hd,
        int(causal), 1.0 / math.sqrt(hd), build.stream_ptr(q.device)),
        "flash_attention")
    return out, lse


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, block_q, block_k, with_lse):
    _check_shapes(q, k, v, causal)
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq) if with_lse else 0, dtype=torch.float32))


def attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs attention computes: S(S+1)/2 causal, Sq·Skv
    otherwise (the bounds' count)."""
    return sq * (sq + 1) // 2 if causal else sq * skv


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    """K7: the two products, 4·B·H·hd a pair."""
    b, sq, h, hd = q_shape
    return 4 * b * h * hd * attention_pairs(sq, k_shape[1], causal)


def _check_kernel_contract(q) -> None:
    """What the CUDA kernels take, by q's metadata alone (a fake tensor
    has it too): bf16, hd in ``KERNEL_HEAD_DIMS``, on a card."""
    if q.dtype != torch.bfloat16 or q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes bf16 with hd in "
                         f"{KERNEL_HEAD_DIMS}, got {q.dtype} hd {q.shape[3]}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _check_kernel_operands(operands: dict) -> None:
    """The contract, and each operand contiguous, on the first operand's
    card, 16-byte aligned (rows load in 16-byte chunks)."""
    q = next(iter(operands.values()))
    _check_kernel_contract(q)
    for name, t in operands.items():
        build.require(t, name, q.dtype, 4, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")


class _FlashAttention(torch.autograd.Function):
    """K7 with its lse saved, and K7b as the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = flash_attention_fwd(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         *ctx.blocks)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """(B, Sq, H, hd) attention of q over k, v in q's dtype.

    Launches the CUDA kernel for CUDA tensors (bf16, hd in
    ``KERNEL_HEAD_DIMS``; the blocks shape only the plain version); CPU
    tensors take the plain version.  Anything else raises.  Under autograd
    (grad mode on, an input requiring a gradient) the call also keeps the
    lse and its backward is :func:`flash_attention_bwd`.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
    return flash_attention_fwd(q, k, v, causal, block_q, block_k, False)[0]


flash_attention.launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = True,
                              block_q: int = 512, block_k: int = 512):
    """The plain PyTorch version of K7b: the same blocked steps in float32.
    D = rowsum(dO ∘ O); then for each key block, the q blocks that see it
    (under causal from its diagonal on): p = exp(s - lse) rounded to v's
    dtype, dV += pᵀ·dO, dS = p ∘ (dO·Vᵀ - D) rounded to q's dtype,
    dK += dSᵀ·q·scale, dQ += dS·k·scale.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    _check_shapes(q, k, v, causal)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    block_q, block_k = _check_blocks(sq, skv, block_q, block_k)
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    def by_kv_head(t):                       # (B, S, H, hd) -> (B, KV, G, S, hd)
        return t.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4).float()

    qr, dor = by_kv_head(q), by_kv_head(dout)
    delta = (dor * by_kv_head(out)).sum(-1)             # (B, KV, G, Sq)
    lser = lse.reshape(b, kvh, g, sq)
    kr = k.permute(0, 2, 1, 3).float()                  # (B, KV, Skv, hd)
    vr = v.permute(0, 2, 1, 3).float()
    dq = torch.zeros_like(qr)
    dk = torch.zeros_like(kr)
    dv = torch.zeros_like(vr)
    for k_lo in range(0, skv, block_k):
        ks = slice(k_lo, k_lo + block_k)
        q_first = (k_lo // block_q) * block_q if causal else 0
        for q_lo in range(q_first, sq, block_q):
            qs = slice(q_lo, q_lo + block_q)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qr[:, :, :, qs],
                             kr[:, :, ks]) * scale
            p = torch.exp(s - lser[:, :, :, qs, None])
            if causal:
                q_pos = q_lo + torch.arange(block_q, device=dev)
                kv_pos = k_lo + torch.arange(block_k, device=dev)
                p = torch.where(q_pos[:, None] >= kv_pos[None, :], p, 0.0)
            do_blk = dor[:, :, :, qs]
            p = p.to(v.dtype).float()
            dv[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", p, do_blk)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do_blk, vr[:, :, ks])
            ds = (p * (dp - delta[:, :, :, qs, None])).to(q.dtype).float()
            dk[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                         qr[:, :, :, qs]) * scale
            dq[:, :, :, qs] += torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                            kr[:, :, ks]) * scale
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        block_q: int = 512, block_k: int = 512):
    """K7b: (dq, dk, dv) of ``flash_attention(q, k, v, causal)`` at the
    upstream gradient ``dout``, from the forward's ``out`` and ``lse``.

    Launches the CUDA kernels for CUDA tensors through the op
    ``repro_torch::flash_attention_bwd`` (bf16, hd in
    ``KERNEL_HEAD_DIMS``: the D pre-pass, which also zeroes the dq order
    counters, and the main kernel, counted as one launch of this wrapper,
    with the float32 dq workspace and the counters allocated by the op);
    CPU tensors take the plain version.  Anything else raises.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         block_q, block_k)
    _check_shapes(q, k, v, causal)
    _check_kernel_contract(q)
    return _bwd_op(q, k, v, out, lse, dout.contiguous(), causal, block_q,
                   block_k)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
            causal: bool, block_q: int, block_k: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return tuple(g.contiguous() for g in flash_attention_bwd_plain(
            q, k, v, out, lse, dout, causal, block_q, block_k))
    _check_shapes(q, k, v, causal)
    _check_kernel_operands(dict(q=q, k=k, v=v, out=out, dout=dout))
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    build.require(lse, "lse", torch.float32, 3, q.device)
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}, "
                         f"want {(b, h, sq)}")
    lib = build.library()
    floats, ints = ctypes.c_longlong(), ctypes.c_longlong()
    build.check(lib.flash_attention_bwd_workspace(
        b, sq, h, hd, ctypes.addressof(floats), ctypes.addressof(ints)),
        "flash_attention_bwd_workspace")
    ws = torch.empty(floats.value, dtype=torch.float32, device=q.device)
    counters = torch.empty(ints.value, dtype=torch.int32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    flash_attention_bwd.launches += 1
    build.check(lib.launch_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), ws.data_ptr(), counters.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kvh, hd,
        int(causal), 1.0 / math.sqrt(hd), build.stream_ptr(q.device)),
        "flash_attention_bwd")
    return dq, dk, dv


@_bwd_op.register_fake
def _bwd_fake(q, k, v, out, lse, dout, causal, block_q, block_k):
    _check_shapes(q, k, v, causal)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape, dout_shape,
               causal, *args, **kwargs) -> int:
    """K7b: the five products (s recomputed, dV, dP, dK, dQ), 10·B·H·hd a
    pair."""
    b, sq, h, hd = q_shape
    return 10 * b * h * hd * attention_pairs(sq, k_shape[1], causal)


flash_attention_bwd.launches = 0


def kernel_info(hd: int = 128, backward: bool = False) -> dict[str, int]:
    """K7's CUDA kernel (or, with ``backward``, K7b's main kernel): its
    registers a thread as compiled at head width ``hd`` (72 and 80: the
    padded 128 instantiation they run), dynamic shared memory a block and threads
    a block (``cudaFuncGetAttributes``); for K7b also its local memory a
    thread, 0 when nothing spilled."""
    names = ("registers", "smem_bytes", "threads") + (
        ("local_bytes",) if backward else ())
    vals = [ctypes.c_int() for _ in names]
    fn = "flash_attention_bwd_info" if backward else "flash_attention_info"
    build.check(getattr(build.library(), fn)(
        hd, *(ctypes.addressof(v) for v in vals)), fn)
    return dict(zip(names, (v.value for v in vals)))
