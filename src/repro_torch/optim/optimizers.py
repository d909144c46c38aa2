"""AdamW / SGD-momentum with global-norm clipping and the cosine schedule.

Counterpart of ``repro.optim.optimizers``, as functions on parameter trees
(nested dicts and lists of tensors, :mod:`repro_torch.tree`): the state
trees mirror the parameter tree, the moments are float32 whatever the
leaf's dtype, and each new parameter is cast back to its leaf's dtype.
Every step follows the reference's order of float32 operations, so both
packages give the same parameters from the same gradients up to the last
bit of a transcendental (``pow``, ``sqrt``, ``cos``) or of a sum's order.

STE awareness: binarized layers train on *latent* float weights clipped
to [-1, 1] after each update (Courbariaux et al.); ``clip_latent_paths``
is a predicate on each leaf's path, the string ``jax.tree_util.keystr``
gives it in the reference (``[0]['w']``, ``['layers']['wq']``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree


class OptState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: Any                     # first moment (params-like, float32)
    nu: Any | None              # second moment (params-like), None for SGD


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warmup -> cosine decay to ``floor * base_lr``; the returned
    function maps a step (int or tensor) to a float32 0-dim tensor on the
    step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = floor * base_lr + (1 - floor) * base_lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


# --------------------------------------------------------------------------
# Grad utilities
# --------------------------------------------------------------------------

def global_norm(grads: Any, rules=None, specs: Any = None) -> torch.Tensor:
    """The float32 L2 norm over every leaf.  With ``rules`` and ``specs``
    (a spec tree of the grads' structure) each rank holds its slices:
    each leaf's sum of squares is summed over the mesh axes its spec
    cuts it on, so a replicated leaf counts once; one scalar psum for
    each set of axes that some leaf is cut on."""
    sums = [g.float().square().sum() for g in tree.leaves(grads)]
    if rules is None:
        return torch.stack(sums).sum().sqrt()
    groups: dict = {}
    for x, spec in zip(sums, tree.leaves(specs)):
        axes = tuple(a for a in rules.mesh.axis_names
                     if any(a == e or (isinstance(e, tuple) and a in e)
                            for e in spec))
        groups.setdefault(axes, []).append(x)
    total = torch.zeros((), dtype=torch.float32, device=sums[0].device)
    for axes, xs in groups.items():
        part = torch.stack(xs).sum()
        total = total + (rules.comm(axes).psum(part) if axes else part)
    return total.sqrt()


def clip_by_global_norm(grads: Any, max_norm: float, rules=None,
                        specs: Any = None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling); ``rules`` and ``specs`` as ``global_norm``'s."""
    norm = global_norm(grads, rules, specs)
    scale = (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)
    return tree.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _zeros_like_tree(params: Any) -> Any:
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)


def _step0(params: Any) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree.leaves(params)[0].device)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw_init(params: Any) -> OptState:
    return OptState(step=_step0(params), mu=_zeros_like_tree(params),
                    nu=_zeros_like_tree(params))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 clip_latent_paths: Callable[[str], bool] | None = None,
                 rules=None, specs: Any = None):
    """One AdamW step.  ``lr`` is a float or a schedule fn(step) -> lr.
    With ``rules`` and ``specs`` (the params' spec tree) each rank passes
    its slices: the clipping norm is the global one (``global_norm``),
    the update elementwise on the slices.

    Returns (new_params, new_state, metrics dict with ``grad_norm`` and
    ``lr``, float32 tensors).
    """
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, rules, specs)
    step = state.step + 1
    lr_t = _lr_at(lr, step)
    b1t = 1 - b1 ** step.to(torch.float32)
    b2t = 1 - b2 ** step.to(torch.float32)

    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(tree.flatten_with_paths(params),
                                  tree.leaves(grads), tree.leaves(state.mu),
                                  tree.leaves(state.nu)):
        gf = g.float()
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf.square()
        mhat = m / b1t
        vhat = v / b2t
        pf = p.float()
        newp = (pf - lr_t * (mhat / (vhat.sqrt() + eps)
                             + weight_decay * pf)).to(p.dtype)
        if clip_latent_paths is not None and clip_latent_paths(path):
            newp = newp.clamp(-1.0, 1.0)
        new_p.append(newp)
        new_m.append(m)
        new_v.append(v)
    return (tree.unflatten(params, new_p),
            OptState(step, tree.unflatten(params, new_m),
                     tree.unflatten(params, new_v)),
            {"grad_norm": gnorm, "lr": lr_t})


# --------------------------------------------------------------------------
# SGD + momentum (vision baselines)
# --------------------------------------------------------------------------

def sgdm_init(params: Any) -> OptState:
    return OptState(step=_step0(params), mu=_zeros_like_tree(params),
                    nu=None)


@torch.no_grad()
def sgdm_update(params: Any, grads: Any, state: OptState, *,
                lr, momentum: float = 0.9, weight_decay: float = 1e-4,
                max_grad_norm: float = 0.0, rules=None, specs: Any = None):
    """One SGD-momentum step; the weight decay is added to the gradient,
    as the reference does.  ``rules`` and ``specs`` as ``adamw_update``'s.
    Returns (new_params, new_state, metrics)."""
    if max_grad_norm:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, rules,
                                           specs)
    else:
        gnorm = global_norm(grads, rules, specs)
    step = state.step + 1
    lr_t = _lr_at(lr, step)

    def upd(p, g, m):
        gf = g.float() + weight_decay * p.float()
        m = momentum * m + gf
        return (p.float() - lr_t * m).to(p.dtype), m

    pairs = [upd(p, g, m) for p, g, m in zip(
        tree.leaves(params), tree.leaves(grads), tree.leaves(state.mu))]
    return (tree.unflatten(params, [p for p, _ in pairs]),
            OptState(step, tree.unflatten(params, [m for _, m in pairs]),
                     None),
            {"grad_norm": gnorm, "lr": lr_t})
