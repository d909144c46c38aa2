"""First-layer bit-plane decomposition (paper §III-B, Eqn 2).

Counterpart of ``repro.core.bitplanes``: (N, H, W, C) uint8 -> 8 bit-planes,
each packed along the channel dim, plane n at index n-1 (plane-major:
plane p occupies words [p*Cw, (p+1)*Cw) once the plane axis is flattened).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing

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
