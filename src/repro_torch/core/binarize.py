"""Sign binarization with the straight-through estimator (training).

Counterpart of ``repro.core.binarize``.  The paper is inference-only;
the binarized networks the engine serves are trained as Courbariaux et
al. [3] train them: the forward pass takes sign(x) in {-1, +1} (0 -> +1),
the backward pass lets the gradient through where |x| <= 1 (the "hard
tanh" STE).  Latent weights stay float and are clipped to [-1, 1] after
each optimizer step.
"""

from __future__ import annotations

import torch


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} with the straight-through gradient (|x| <= 1
    window)."""
    return _SteSign.apply(x)


def clip_latent(w: torch.Tensor) -> torch.Tensor:
    """Latent float weights clipped to [-1, 1] (after each optimizer
    step)."""
    return w.clamp(-1.0, 1.0)


def binarize01(x: torch.Tensor) -> torch.Tensor:
    """{0, 1}-bit view of sign(x) (bit 1 <-> +1), int32."""
    return (x >= 0).to(torch.int32)
