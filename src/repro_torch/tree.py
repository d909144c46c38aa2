"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors.

The port keeps the reference's pytrees as plain containers.  These helpers
walk them as ``jax.tree_util`` does: dict keys in sorted order, ``None``
holding no leaf, and each leaf named by the string
``jax.tree_util.keystr`` gives its path (``['layers']['wq']``, ``[0]['w']``,
``.mu`` for a NamedTuple field), so a predicate on paths (the optimisers'
``clip_latent_paths``) and a checkpoint's keys read the same in both
packages.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields
                for pair in flatten_with_paths(getattr(tree, name),
                                               f"{prefix}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree)
                for pair in flatten_with_paths(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in the
    flattening order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}         # the caller's key order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])


def value_and_grad(fn: Callable, params: Any, *args, **kwargs):
    """``jax.value_and_grad(fn, has_aux=True)`` over a tree of float
    tensors: returns ((value, aux), grads), the grads a tree of
    ``params``' structure (zeros for a leaf the value does not reach).
    The leaves are detached and made to require a gradient, so the
    caller's tensors are left alone."""
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    with torch.enable_grad():
        value, aux = fn(unflatten(params, flat), *args, **kwargs)
        grads = torch.autograd.grad(value, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    aux = tree_map(lambda t: t.detach() if torch.is_tensor(t) else t, aux)
    return (value.detach(), aux), unflatten(params, grads)
