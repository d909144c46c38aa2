"""First-layer bit-plane decomposition (paper §III-B, Eqn 2).

Counterpart of ``repro.core.bitplanes``: (N, H, W, C) uint8 -> 8 bit-planes,
each packed along the channel dim, plane n at index n-1 (plane-major:
plane p occupies words [p*Cw, (p+1)*Cw) once the plane axis is flattened).
"""

from __future__ import annotations

import torch

from repro_torch.core import binary_ops, packing

NUM_PLANES = 8


def split_bitplanes(x: torch.Tensor) -> torch.Tensor:
    """(..., C) uint8/int -> (..., 8, C) int32 bits, plane n at index n-1."""
    x = torch.as_tensor(x).to(torch.int32)
    shifts = torch.arange(NUM_PLANES, dtype=torch.int32, device=x.device)
    return (x.unsqueeze(-2) >> shifts[:, None]) & 1


def pack_bitplanes(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, H, W, 8, Cw) packed int32 planes."""
    return packing.pack_bits(split_bitplanes(x), axis=-1)


def plane_word_weights(c_words: int, device=None) -> torch.Tensor:
    """(8*Cw,) int32 word-weight vector: 2^(n-1) for every word of plane n."""
    w = torch.ones((), dtype=torch.int32) << torch.arange(
        NUM_PLANES, dtype=torch.int32)
    return torch.repeat_interleave(w, c_words).to(device)


# --------------------------------------------------------------------------
# First-layer filters as one u8 x s8 product
# --------------------------------------------------------------------------
#
# The converter copies each first-layer tap's sign words into all 8 planes,
# and plane p's words weigh 2^p.  For one bit position with filter bit b
# (1 <-> +1, s = 2b - 1) and input byte x = sum_p 2^p x_p:
#     sum_p 2^p (x_p xor b) = (b ? 255 - x : x) = 255 b - s x,
# so over every tap, word and bit position of a filter
#     cnt[m, o] = 255 * popcount(filter o's sign words) - sum s * x,
# an unsigned-byte by +-1 product, exact for any input words.

# Largest K for which a float32 product of bytes and +-1 stays exact:
# every partial sum is below 2^24.
_EXACT_F32_K = (1 << 24) // 255


class PlaneFilters:
    """First-layer filters in the u8 x s8 form: ``signs`` (O, taps·Cw)
    int32, one plane's sign words; ``bytes`` (O, taps·Cw·32) int8, their
    +-1 bits (the s8 matrix K1's variant reads); and ``const`` (O,) int32,
    ``255 · popcount(signs[o])``."""

    __slots__ = ("signs", "bytes", "const")

    def __init__(self, signs: torch.Tensor, const: torch.Tensor):
        self.signs = signs
        self.bytes = packing.unpack_to_pm1(signs, signs.shape[1] * 32,
                                           dtype=torch.int8).contiguous()
        self.const = const


def plane_filters(w_packed: torch.Tensor, word_weights: torch.Tensor,
                  taps: int) -> PlaneFilters:
    """Check, on the host, that ``w_packed`` (O, taps·8·Cw) holds the
    converter's first-layer structure — word weights 2^p for plane p and
    the 8 planes of every tap equal — and return its u8 x s8 form.
    Raises ``ValueError`` when either does not hold."""
    w = w_packed.detach().cpu()
    o, k = w.shape
    if k % (taps * NUM_PLANES):
        raise ValueError(f"plane filters: {k} words are not {taps} taps of "
                         f"{NUM_PLANES} planes")
    cw = k // (taps * NUM_PLANES)
    want = plane_word_weights(cw).repeat(taps)
    if word_weights is None or not torch.equal(
            word_weights.detach().cpu().to(torch.int32), want):
        raise ValueError("plane filters: word weights are not 2^p for "
                         "plane p")
    planes = w.reshape(o, taps, NUM_PLANES, cw)
    if not bool((planes == planes[:, :, :1]).all()):
        raise ValueError("plane filters: the 8 planes of a tap differ")
    signs = planes[:, :, 0].reshape(o, taps * cw).contiguous()
    const = 255 * packing.popcount(signs).sum(dim=1).to(torch.int32)
    return PlaneFilters(signs.to(w_packed.device),
                        const.to(w_packed.device))


def plane_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., 8·Cw) plane words (plane-major) -> (..., Cw·32) int32 bytes:
    byte j of word c is sum_p 2^p · bit j of plane p's word c."""
    cw = words.shape[-1] // NUM_PLANES
    bits = packing.unpack_bits(
        words.reshape(words.shape[:-1] + (NUM_PLANES, cw)), cw * 32)
    weights = (1 << torch.arange(NUM_PLANES, dtype=torch.int32,
                                 device=words.device))
    return (bits * weights[:, None]).sum(dim=-2, dtype=torch.int32)


def byte_sign_dot(u: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """(M, N) int64 sum_k u[m, k] · s[n, k] of bytes ``u`` (M, K) and the
    +-1 bits of ``signs`` (N, K/32) words, by float32 products (TF32 off)
    over slabs of K short enough to stay exact."""
    s = packing.unpack_to_pm1(signs, signs.shape[1] * 32,
                              dtype=torch.float32)
    uf = u.to(torch.float32)
    out = torch.zeros((u.shape[0], s.shape[0]), dtype=torch.int64,
                      device=u.device)
    with binary_ops.full_float32():
        for k0 in range(0, u.shape[1], _EXACT_F32_K):
            k1 = k0 + _EXACT_F32_K
            out += (uf[:, k0:k1] @ s[:, k0:k1].T).to(torch.int64)
    return out
