"""Channel compression (paper §V-A): bit-packing along the channel dimension.

Counterpart of ``repro.core.packing`` on torch tensors.  Same encoding:

    bit 1  <->  +1
    bit 0  <->  -1

packed LSB-first into int32 words; channels that do not fill the last word
are 0-bits.  Bit 31 is stored as the int32 bit pattern (INT32_MIN), never
through uint32, which torch supports only thinly.

torch's ``>>`` on int32 is an arithmetic shift, so every shift below is
followed by a mask.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def num_words(channels: int) -> int:
    """Number of int32 words needed to hold ``channels`` bits."""
    return -(-channels // WORD_BITS)


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack {0,1} values (bool or any numeric dtype) into int32 words along
    ``axis``; that dim becomes ``num_words(C)``.

    The 32 shifted bits of a word are distinct powers of two and at most
    one of them (bit 31) is negative, so their int32 sum never overflows
    and equals the bitwise OR.
    """
    bits = torch.as_tensor(bits)
    axis = axis % bits.ndim
    c = bits.shape[axis]
    w = num_words(c)
    bits = bits.movedim(axis, -1).to(torch.int32)
    pad = w * WORD_BITS - c
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (w, WORD_BITS))
    words = torch.sum(bits << _shifts(bits.device), dim=-1, dtype=torch.int32)
    return words.movedim(-1, axis)


def unpack_bits(words: torch.Tensor, channels: int,
                axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns an int32 {0,1} tensor."""
    words = torch.as_tensor(words)
    axis = axis % words.ndim
    words = words.movedim(axis, -1)
    bits = (words.unsqueeze(-1) >> _shifts(words.device)) & 1
    bits = bits.reshape(bits.shape[:-2] + (bits.shape[-2] * WORD_BITS,))
    return bits[..., :channels].movedim(-1, axis)


def pack_signs(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Binarize a float tensor by sign (>= 0 -> bit 1) and pack along
    ``axis``."""
    return pack_bits(torch.as_tensor(x) >= 0, axis=axis)


def unpack_to_pm1(words: torch.Tensor, channels: int, axis: int = -1,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Unpack words to a +-1-valued tensor of ``dtype``."""
    bits = unpack_bits(words, channels, axis=axis)
    return (2 * bits - 1).to(dtype)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Number of set bits per int32 word (int32 result).

    torch has no popcount op, so this is the SWAR reduction on int32.  Only
    the first step can wrap (its int32 subtraction), and two's-complement
    wrapping leaves exactly the per-pair counts; every later value is
    non-negative.
    """
    x = words.to(torch.int32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F
