"""K4: first-layer bit-plane split + channel packing (C8, Eqn 2).

Port of ``repro.kernels.bitplane_pack.bitplane_pack``; the CUDA kernel is
``csrc/bitplane_pack.cu``.  (N, H, W, C) uint8 -> (N, H, W, 8*Cw) int32,
plane-major per pixel (plane p occupies words [p*Cw, (p+1)*Cw)).  Each
block of the kernel stages a span of pixels' bytes in shared memory, so a
pixel's C bytes must fit a span: C is at most :data:`MAX_CHANNELS`.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitplanes, packing
from repro_torch.kernels import build

# csrc/bitplane_pack.cu kSpanBytes: the input bytes a block stages.
MAX_CHANNELS = 16384


def bitplane_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``core.bitplanes.pack_bitplanes`` with the
    plane axis flattened into the word axis."""
    planes = bitplanes.pack_bitplanes(x)          # (N, H, W, 8, Cw)
    n, h, w, np_, cw = planes.shape
    return planes.reshape(n, h, w, np_ * cw)


def bitplane_pack(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, H, W, 8*Cw) int32 packed planes.

    Launches the CUDA kernel for a CUDA tensor; a CPU tensor takes the plain
    version.
    """
    if x.device.type == "cpu":
        return bitplane_pack_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"bitplane_pack: unsupported device {x.device}")
    build.require(x, "x", torch.uint8, 4, x.device)
    n, h, w, c = x.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"bitplane_pack: {c} channels, the kernel takes 1 "
                         f"to {MAX_CHANNELS}")
    out = torch.empty((n, h, w, bitplanes.NUM_PLANES * packing.num_words(c)),
                      dtype=torch.int32, device=x.device)
    lib = build.library()
    bitplane_pack.launches += 1
    build.check(lib.launch_bitplane_pack(
        x.data_ptr(), out.data_ptr(), n * h * w, c,
        build.stream_ptr(x.device)), "bitplane_pack")
    return out


bitplane_pack.launches = 0
