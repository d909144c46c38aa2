"""One rank's layout of the vision and diffusion zoo on a mesh.

The reference runs ViT, DiT, ConvNeXt and EfficientNet under ``rules``:
it hands XLA a spec for each parameter (``param_specs``) and constrains a
few activations, and XLA partitions the program.  The port runs one
process a rank, so :class:`Layout` writes out the collectives those
specs imply, each one of ``distributed.sharding``'s differentiable ops,
and the four models call its hooks; without ``rules`` the models take
their one-device path, the same ops as before they took ``rules``.

* Batch: each rank's rows (``rules.batch_cut``: cut over the batch axes
  ``batch_spec`` keeps, whole on the ranks of the ones it leaves out); a
  train step's batch is the rank's rows already.  The loss's sum over the
  batch axes is divided by the rows of every batch rank, which counts a
  replicated row once a copy in both, so the loss is the global mean,
  each copy's gradient is its share, and the sums over the batch axes
  (``sync_grads``, ``gather_fsdp``'s backward, the synced BN's
  ``sum_stats``) need no scaling.
* FSDP: the leaves cut over ``rules.fsdp`` are all-gathered where they
  are used, a layer's in one flat collective whose backward
  reduce-scatters the cotangents (``gather_fsdp``).
* ``model``: the residual stream is whole over ``model`` on every rank
  (DiT can cut its tokens instead, ``dit.py``).  A product whose weight's
  output columns are cut over ``model`` is column-parallel (its input
  through ``copy_to_model``), one whose input rows are cut is
  row-parallel (``layers.row_parallel``: float32 partials summed and
  rounded once).  A leaf cut over ``model`` that feeds work every model
  rank runs alike (a convolution over whole channels, a batch-norm scale)
  is gathered with its own block as the backward
  (``gather_model_leaves``).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding
from repro_torch.models import layers


def axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dim_of(spec, axis: str) -> int | None:
    """The dim of ``spec`` cut over ``axis``, or None."""
    return next((d for d, e in enumerate(spec) if axis in axes_of(e)),
                None)


class Layout:
    """The hooks one rank's forward calls under ``rules``.  Without
    ``rules`` (one device) only the batch's and the gradient's hooks are
    called, and are the identity; the models call the others on a mesh
    alone."""

    def __init__(self, rules=None):
        self.rules = rules
        self.on = rules is not None
        self.tp = rules.tp if self.on else 1
        self.dp = rules.dp if self.on else 1
        if self.on:
            self.model = rules.comm(rules.model)
            self.fsdp_comm = rules.comm(rules.fsdp)
            self.batch = rules.comm(rules.batch)

    # ---- parameters ---------------------------------------------------------
    def fsdp(self, leaves: list, specs: list) -> list:
        """``leaves`` whole over ``fsdp`` (one flat gather, reduce-scatter
        backward)."""
        dims = [dim_of(s, self.rules.fsdp) for s in specs]
        return sharding.gather_fsdp(leaves, dims, self.fsdp_comm)

    def whole(self, leaves: list, specs: list) -> list:
        """``leaves`` whole over ``model``, for work every model rank runs
        alike (one flat gather, each rank's own block backward)."""
        dims = [dim_of(s, self.rules.model) for s in specs]
        return sharding.gather_model_leaves(leaves, dims, self.model)

    def layer(self, lp: dict, specs: dict) -> dict:
        """One layer's leaves (the stacked specs' layer dim dropped) whole
        over ``fsdp``."""
        names = list(lp)
        got = self.fsdp([lp[n] for n in names],
                        [sharding.P(*list(specs[n])[1:]) for n in names])
        return dict(zip(names, got))

    def part(self, t: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """The rank's block of a leaf replicated over ``model`` whose
        parts the ranks read (a bias of a column-parallel product): its
        cotangent gathered whole again."""
        return sharding.split_model(t, self.model, axis)

    # ---- products -----------------------------------------------------------
    def col_in(self, h: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel product: whole on every model
        rank, its cotangent summed over them."""
        return sharding.copy_to_model(h, self.model)

    def row(self, a: torch.Tensor, w: torch.Tensor,
            scatter_axis: int | None = None) -> torch.Tensor:
        """``a @ w`` with w's rows cut over ``model`` (a row-parallel
        product)."""
        return layers.row_parallel(a, w, self.model, scatter_axis)

    # ---- the batch ----------------------------------------------------------
    def batch_axes(self, b: int) -> tuple[str, ...]:
        return axes_of(self.rules.batch_spec(b)) if self.on else ()

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a whole batch (serving, and a train step's
        batch before it is placed)."""
        if not self.on:
            return x
        return self.rules.batch_cut(x.shape[0]).take(x)

    def gather_rows(self, y: torch.Tensor, b: int) -> torch.Tensor:
        """A serving output of the rank's rows whole again on every
        rank."""
        axes = self.batch_axes(b)
        if not axes:
            return y
        return self.rules.comm(axes).all_gather(y, axis=0)

    def mean_over_batch(self, total: torch.Tensor, n: int) -> torch.Tensor:
        """A loss sum of the rank's ``n`` rows as the mean over the global
        batch, the same on every rank: the sum over every batch rank over
        their rows, so a row held by ``copies`` ranks counts ``copies``
        times in both."""
        return sharding.psum(total, self.batch) / (n * self.batch.size)

    def sync(self, grads, specs):
        """The gradient summed over the batch axes a leaf is replicated
        over (``sharding.sync_grads``)."""
        if not self.on:
            return grads
        return sharding.sync_grads(grads, specs, self.rules)


def conv_spec(spec_hwio) -> sharding.P:
    """A reference conv kernel's spec, (KH, KW, I, O) or stacked (L, KH,
    KW, I, O), in the port's (O, I, KH, KW) layout (``layers.hwio_to_oihw``'s
    permutation)."""
    e = list(spec_hwio)
    if len(e) == 4:
        return sharding.P(e[3], e[2], e[0], e[1])
    return sharding.P(e[0], e[4], e[3], e[1], e[2])


def shard_params(full, specs, rules):
    """``full`` cut to this rank's slices (``sharding.shard_tree``), or
    ``full`` itself without ``rules``."""
    if rules is None:
        return full
    return sharding.shard_tree(full, specs, rules)
