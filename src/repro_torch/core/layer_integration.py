"""Layer integration (paper §V-B + §VI-C, Eqns 3-9).

Counterpart of ``repro.core.layer_integration``.  BN(+bias)+sign after a
binary conv folds into an integer threshold on the xor-popcount, evaluated
at run time as ``x4 = (cnt <= t) xor s`` with ``s = [gamma < 0]``.

The folding runs in float32 with the reference's exact operation order:
float64 would move ``floor``/``ceil`` at the boundaries and the integer
thresholds would no longer match the JAX artifact bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IntegratedParams(NamedTuple):
    """Offline-folded parameters of one integrated conv+BN+sign layer."""
    threshold: torch.Tensor  # (O,) int32 — compare against popcount
    sign_flip: torch.Tensor  # (O,) bool  — xor after the compare


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def fold_bn(k_valid, gamma, beta, mu, sigma, bias=0.0) -> IntegratedParams:
    """Fold BN(+bias) into an integer popcount threshold (offline, Eqn 6).

    k_valid: valid bits per output (K = KH*KW*C_in), scalar or (O,).
    sigma: sqrt(running_var + eps) — the paper's sigma.
    """
    gamma, beta, mu, sigma = map(_f32, (gamma, beta, mu, sigma))
    xi = mu - beta * sigma / gamma - _f32(bias)                 # Eqn 6
    half = (_f32(k_valid) - xi) / 2.0
    t_pos = torch.floor(half)                                   # gamma > 0
    t_neg = torch.ceil(half) - 1.0                              # gamma < 0
    s = gamma < 0
    t = torch.where(s, t_neg, t_pos)
    return IntegratedParams(t.to(torch.int32), s)


def fold_bn_first_layer(k_valid: int, w_sum, gamma, beta, mu, sigma,
                        bias=0.0) -> IntegratedParams:
    """Fold BN into a threshold on the bit-plane-weighted popcount (Eqn 2):
    thresholding ``s >= xi`` becomes ``wcnt <= C1 - xi`` with
    ``C1 = 255*(K + w_sum)/2`` (see the reference docstring for the
    derivation).  w_sum: (O,) sum of each filter's +-1 weights."""
    gamma, beta, mu, sigma = map(_f32, (gamma, beta, mu, sigma))
    xi = mu - beta * sigma / gamma - _f32(bias)
    c1 = 255.0 * (_f32(k_valid) + _f32(w_sum)) / 2.0
    lim = c1 - xi
    t_pos = torch.floor(lim)
    t_neg = torch.ceil(lim) - 1.0
    s = gamma < 0
    t = torch.where(s, t_neg, t_pos)
    return IntegratedParams(t.to(torch.int32), s)


def apply_threshold(cnt: torch.Tensor, p: IntegratedParams) -> torch.Tensor:
    """Runtime epilogue: {0,1} int32 bits, x4 = (cnt <= t) xor s."""
    return ((cnt <= p.threshold) ^ p.sign_flip).to(torch.int32)
