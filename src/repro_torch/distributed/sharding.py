"""Mesh-axis sharding rules for the LM stack and the vision and diffusion
zoo, their collectives, and the data-parallel serving placement
(DESIGN.md §13).

Counterpart of ``repro.distributed.sharding``.  One :class:`Rules` object
says how a mesh's axes are used, with the reference's arithmetic and its
divisibility fallbacks (a dim that does not divide an axis's size stays
whole):

* ``batch`` axes — data parallelism (``("data",)``, or ``("pod",
  "data")`` on the three-axis mesh);
* ``model`` — tensor parallelism: attention heads, the MLP's hidden dim,
  the experts (EP), the vocab, and the decode KV cache's sequence dim;
* ``fsdp`` — parameters are also cut over ``data`` and all-gathered a
  layer at a time where they are used.

A spec (:class:`P`, the counterpart of ``PartitionSpec``) names, for each
dim of a tensor, the mesh axis or axes it is cut over, or ``None``.  The
reference hands specs to XLA, which partitions the program; the port runs
one process a rank on plain local tensors: :func:`local_shard` cuts a
full tensor to this rank's slice, :func:`gather` puts one back together,
and :class:`Collective` holds the counterparts of the ``lax`` collectives
the reference's per-shard code calls (tiled ``all_to_all``, ``psum``,
``pmax``, ``pmean``, ``all_gather``) over one set of mesh axes.

``DataParallel`` is the serving placement: the reference shards each
bucket's batch dim over a mesh axis inside one XLA executable.  Torch has
no such executable, so the port names the shards' devices: the server
rounds each bucket up to a multiple of the shard count, and
``engine.compile(..., data_parallel=devices)`` splits the padded bucket
into equal row shards, runs one executor a device at ``bucket // n`` and
gathers the rows on the first device
(:class:`~repro_torch.runtime.placement.ShardedExecutor`).  The rows equal
the single-device forward's bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.distributed.pipeline import visible_cards


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------

class P:
    """A partition spec: one entry a dim, each ``None``, an axis name or a
    tuple of axis names.  Equal to the tuple of its entries (and so to a
    reference ``PartitionSpec`` turned into one).  Not a tuple itself, so
    a tree of specs has specs for leaves."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

class Collective:
    """The reference's ``lax`` collectives over one set of mesh axes:
    ``size`` ranks, this one at ``index``.  Over one rank each is the
    identity.  ``staged``: the group's backend cannot read CUDA memory
    (gloo on ranks that share a card), so a CUDA tensor goes through
    pinned host memory and back.

    These are the forward ops alone: autograd does not see them.  A tensor
    that requires a gradient (with grad mode on) is refused, naming the
    differentiable op of this module to use instead (``copy_to_model``,
    ``reduce_from_model``, ``gather_fsdp``, ``gather_model``,
    ``split_model``, ``all_to_all``, ``pmean``), so that no path can drop
    a gradient silently."""

    # Bytes of the tensors this process has handed to collectives of more
    # than one rank (each call's input once), and the count of those
    # calls, for the smoke's accounting and the remat tests.
    payload_bytes = 0
    calls = 0
    # While :meth:`recording` holds it, a list that gets one record a call
    # of more than one rank: the reference's HLO kind ("all-reduce",
    # "all-gather", "reduce-scatter", "all-to-all"), the operand's and the
    # result's bytes, the group's size and its members' global ranks (the
    # dry-run's link class).
    recorder: list | None = None

    def __init__(self, group, size: int, index: int, staged: bool = False):
        self.group, self.size, self.index = group, size, index
        self.staged = staged
        self._ranks = None

    @classmethod
    @contextlib.contextmanager
    def recording(cls):
        """Record every collective of more than one rank run inside the
        block into the list it yields."""
        saved, cls.recorder = cls.recorder, []
        try:
            yield cls.recorder
        finally:
            cls.recorder = saved

    @property
    def ranks(self) -> tuple[int, ...]:
        """The group's global ranks, in its order."""
        if self._ranks is None:
            self._ranks = tuple(dist.get_process_group_ranks(
                self.group if self.group is not None else dist.group.WORLD))
        return self._ranks

    @staticmethod
    def _refuse_grad(x: torch.Tensor, op: str) -> None:
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"Collective.{op} on a tensor that requires grad: autograd "
                f"would not see the collective; use {_DIFFERENTIABLE[op]}")

    def _host(self, x: torch.Tensor, kind: str, out_n: float = 1.0
              ) -> torch.Tensor:
        """``x`` as the group's backend reads it (counted, and recorded
        as ``kind`` with a result ``out_n`` times its size)."""
        nbytes = x.numel() * x.element_size()
        Collective.payload_bytes += nbytes
        Collective.calls += 1
        if Collective.recorder is not None:
            Collective.recorder.append(dict(
                kind=kind, operand_bytes=nbytes,
                out_bytes=int(nbytes * out_n), group=self.size,
                ranks=self.ranks))
        x = x.contiguous()
        if not (self.staged and x.is_cuda):
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h

    @staticmethod
    def _like(h: torch.Tensor, shape) -> torch.Tensor:
        """An output buffer beside ``h`` (pinned when ``h`` is)."""
        if h.is_cuda:
            return torch.empty(shape, dtype=h.dtype, device=h.device)
        return torch.empty(shape, dtype=h.dtype, pin_memory=h.is_pinned())

    @staticmethod
    def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        # From pinned memory the copy back is queued, not waited for: the
        # host allocator keeps ``h`` until the stream has read it.
        return h if h.device == like.device else h.to(like.device,
                                                      non_blocking=True)

    def _reduce(self, x, op, name: str) -> torch.Tensor:
        self._refuse_grad(x, name)
        if self.size == 1:
            return x
        h = self._host(x, "all-reduce")
        if h is x:
            h = x.clone()
        dist.all_reduce(h, op=op, group=self.group)
        return self._back(h, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM, "psum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX, "pmax")

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM, "pmean") / self.size

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``axis`` in rank order
        (``lax.all_gather(..., tiled=True)``)."""
        self._refuse_grad(x, "all_gather")
        if self.size == 1:
            return x
        h = self._host(x, "all-gather", self.size)
        buf = self._like(h, (self.size, *h.shape))
        dist.all_gather(list(buf.unbind(0)), h, group=self.group)
        return torch.cat(self._back(buf, x).unbind(0), dim=axis)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x (size, ...) -> this rank's block summed over the ranks: the
        transpose of a gather.  One ``all_to_all`` of the blocks, then a
        sum in rank order (gloo's reduce-scatter is not in every torch)."""
        self._refuse_grad(x, "reduce_scatter")
        if self.size == 1:
            return x[0]
        h = self._host(x, "reduce-scatter", 1 / self.size)
        out = self._like(h, h.shape)
        dist.all_to_all_single(out, h, group=self.group)
        return self._back(out, x).sum(0)

    def all_to_all(self, x: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``:
        ``split_axis`` cut into ``size`` blocks, block j sent to rank j,
        the blocks received concatenated along ``concat_axis`` in rank
        order."""
        self._refuse_grad(x, "all_to_all")
        if self.size == 1:
            return x
        n = self.size
        moved = x.movedim(split_axis, 0)
        if moved.shape[0] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} does not split over {n}")
        blocks = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:])
        h = self._host(blocks, "all-to-all")
        out = self._like(h, h.shape)
        dist.all_to_all_single(out, h, group=self.group)
        out = self._back(out, x)
        # out[i] is rank i's block, in the moved layout: back to x's
        # layout, then rank blocks merged into the concat dim.
        out = out.movedim(1, split_axis + 1)
        out = out.movedim(0, concat_axis)
        shape = list(out.shape)
        merged = shape[:concat_axis] + [n * shape[concat_axis + 1]] \
            + shape[concat_axis + 2:]
        return out.reshape(merged)


_DIFFERENTIABLE = {
    "psum": "reduce_from_model (psum forward, identity backward) or "
            "copy_to_model (identity forward, psum backward)",
    "pmax": "it on a detached tensor (a max shift has no gradient)",
    "pmean": "pmean (the mean forward, its share backward)",
    "all_gather": "gather_fsdp (reduce-scatter backward) or gather_model "
                  "(the rank's own block backward)",
    "reduce_scatter": "gather_fsdp (its backward) or "
                      "reduce_scatter_model",
    "all_to_all": "all_to_all (the inverse all_to_all backward)",
}


# --------------------------------------------------------------------------
# Differentiable collectives
# --------------------------------------------------------------------------
#
# The port runs one process a rank, so every collective that XLA inserts
# into the reference's gradient is written out here.  Every rank's loss is
# the global loss, so each op's backward is the transpose of its forward
# given the cotangent it really receives: a tensor replicated over
# ``model`` has the same, whole cotangent on every model rank; a tensor
# that differs by ``data`` rank (each rank's own batch rows) has its own.
# Each op takes a ``Collective`` (or anything with its methods), never a
# tensor's gradient through ``Collective`` itself.

def _sum_wide(comm, x: torch.Tensor) -> torch.Tensor:
    """psum in float32, rounded back once to x's dtype."""
    if x.dtype in (torch.float32, torch.float64):
        return comm.psum(x)
    return comm.psum(x.float()).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_wide(ctx.comm, g), None


def copy_to_model(x: torch.Tensor, comm) -> torch.Tensor:
    """Identity forward, psum backward (in float32): the input of a
    column-parallel product (and the vocab-parallel head), whole on every
    rank, whose ranks each take a part of its cotangent.  Also a
    replicated parameter read by rank-local work (``q_norm`` on the
    rank's heads, the router on the rank's tokens)."""
    if comm.size == 1:
        return x
    return _CopyToModel.apply(x, comm)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(x: torch.Tensor, comm) -> torch.Tensor:
    """psum forward, identity backward: a sum of the ranks' parts whose
    result every rank holds and reads alike (a row-parallel sum, the
    masked embedding lookup, the vocab-parallel CE's partials)."""
    if comm.size == 1:
        return x
    return _ReduceFrom.apply(x, comm)


# The loss's sums over the batch axes: each rank's rows in, the global sum
# out on every rank, whose cotangent is each rank's own.
psum = reduce_from_model


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, copies):
        ctx.share = copies / comm.size
        return comm.psum(x) / comm.size

    @staticmethod
    def backward(ctx, g):
        return g * ctx.share, None, None


def pmean(x: torch.Tensor, comm, copies: int = 1) -> torch.Tensor:
    """The mean over ``comm``'s ranks; backward each rank's share of the
    cotangent.  ``copies``: how many ranks hold the same value (a value
    replicated over ``model`` is averaged ``tp`` times over; its
    cotangent is the share of one of the distinct values, ``copies /
    size``)."""
    if comm.size == 1:
        return x
    return _Pmean.apply(x, comm, copies)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis, ctx.n = comm, axis, x.shape[axis]
        return comm.all_gather(x, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.axis, ctx.comm.index * ctx.n, ctx.n), None,
                None)


def gather_model(x: torch.Tensor, comm, axis: int = 0) -> torch.Tensor:
    """all_gather forward; backward the rank's own block of the cotangent:
    a gather whose result every rank reads alike (weights gathered for
    work run whole on every model rank, the MoE's output)."""
    if comm.size == 1:
        return x
    return _GatherModel.apply(x, comm, axis % x.dim())


class _SplitModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        n = x.shape[axis] // comm.size
        return x.narrow(axis, comm.index * n, n)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, axis=ctx.axis), None, None


def split_model(x: torch.Tensor, comm, axis: int = 0) -> torch.Tensor:
    """The rank's block of x forward (x whole on every rank); all_gather
    backward, so that x's cotangent is whole again."""
    if comm.size == 1:
        return x
    if x.shape[axis] % comm.size:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"over {comm.size}")
    return _SplitModel.apply(x, comm, axis % x.dim())


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return comm.all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (ctx.comm.all_to_all(g.contiguous(), concat_axis, split_axis),
                None, None, None)


def all_to_all(x: torch.Tensor, comm, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``Collective.all_to_all`` forward, the inverse all_to_all
    backward."""
    if comm.size == 1:
        return x
    return _AllToAll.apply(x, comm, split_axis, concat_axis)


def _reduce_scatter(comm, x: torch.Tensor, axis: int) -> torch.Tensor:
    """x summed over ``comm``'s ranks, this rank's block along ``axis``:
    sums of the rank-ordered blocks at least in float32, rounded once to
    x's dtype."""
    n = x.shape[axis] // comm.size
    blocks = x.unflatten(axis, (comm.size, n)).movedim(axis, 0)
    wide = torch.promote_types(x.dtype, torch.float32)
    return comm.reduce_scatter(blocks.to(wide)).to(x.dtype)


class _ReduceScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return _reduce_scatter(comm, x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g.contiguous(), axis=ctx.axis), None, None


def reduce_scatter_model(x: torch.Tensor, comm, axis: int) -> torch.Tensor:
    """Each rank's partial sum x summed over ``comm`` (float32, rounded
    once), the rank's block along ``axis`` forward; all_gather backward
    (the transpose: each rank's cotangent is its own block's).  The
    Megatron-SP block boundary, DiT's sequence-sharded residual: its
    fused form with the row-parallel product is ``layers.row_parallel(...,
    scatter_axis=)``."""
    if comm.size == 1:
        return x
    if x.shape[axis] % comm.size:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"over {comm.size}")
    return _ReduceScatterModel.apply(x, comm, axis % x.dim())


class _SumStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.psum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.psum(g), None


def sum_stats(x: torch.Tensor, comm) -> torch.Tensor:
    """psum forward and psum backward: a statistic summed over the batch
    axes whose sum every rank then reads on its own rows (train-mode batch
    norm's per-channel sums).  Each rank's cotangent is its rows' part, so
    the transpose of the all-reduce is the all-reduce."""
    if comm.size == 1:
        return x
    return _SumStats.apply(x, comm)


class _GatherFsdp(torch.autograd.Function):
    """Leaves all_gathered along their dims in one flat collective; the
    backward reduce-scatters their cotangents in one flat collective, or,
    with ``own``, takes each leaf's own block of them (every rank read the
    result alike)."""

    @staticmethod
    def forward(ctx, comm, dims, own, *xs):
        ctx.comm, ctx.dims, ctx.own = comm, dims, own
        ctx.shapes = [x.movedim(d, 0).shape for x, d in zip(xs, dims)]
        flat = torch.cat([x.movedim(d, 0).reshape(-1)
                          for x, d in zip(xs, dims)])
        full = comm.all_gather(flat, axis=0).view(comm.size, -1)
        out, lo = [], 0
        for shape, d in zip(ctx.shapes, dims):
            k = math.prod(shape)
            part = full[:, lo:lo + k].reshape(comm.size * shape[0],
                                               *shape[1:])
            out.append(part.movedim(0, d).contiguous())
            lo += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.comm.size
        if ctx.own:
            i = ctx.comm.index
            return (None, None, None, *(
                g.narrow(d, i * s[0], s[0])
                for g, d, s in zip(gs, ctx.dims, ctx.shapes)))
        flat = torch.cat([g.movedim(d, 0).reshape(n, -1)
                          for g, d in zip(gs, ctx.dims)], dim=1)
        mine = ctx.comm.reduce_scatter(flat)
        out, lo = [], 0
        for shape, d in zip(ctx.shapes, ctx.dims):
            k = math.prod(shape)
            out.append(mine[lo:lo + k].reshape(shape).movedim(0, d))
            lo += k
        return (None, None, None, *out)


def gather_fsdp(xs: Sequence[torch.Tensor], dims: Sequence[int | None],
                comm) -> list[torch.Tensor]:
    """Each ``xs[i]`` all_gathered along ``dims[i]`` over ``comm`` (None:
    left as it is), one flat collective a dtype; backward the transpose,
    a reduce-scatter (sum) of the cotangents: each rank's cotangent is its
    own rows' part of the gradient.  FSDP's gather of a layer's leaves a
    layer at a time, and any gather whose ranks read different parts of
    the result (``wk`` / ``wv`` gathered for the KV heads each rank's q
    heads read)."""
    return _gather_leaves(xs, dims, comm, own=False)


def gather_model_leaves(xs: Sequence[torch.Tensor],
                        dims: Sequence[int | None], comm) -> list:
    """:func:`gather_model` of many leaves in one flat collective a
    dtype: each ``xs[i]`` all_gathered along ``dims[i]`` (None: left as
    it is), backward each rank's own block of the cotangents.  Weights
    gathered for work every rank of ``comm`` runs alike (the zoo's
    convolutions over whole channels)."""
    return _gather_leaves(xs, dims, comm, own=True)


def _gather_leaves(xs, dims, comm, own: bool) -> list:
    out = list(xs)
    if comm.size == 1:
        return out
    by_dtype: dict = {}
    for i, (x, d) in enumerate(zip(xs, dims)):
        if d is not None:
            by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        got = _GatherFsdp.apply(comm, tuple(dims[i] % xs[i].dim()
                                            for i in idx), own,
                                *(xs[i] for i in idx))
        for i, t in zip(idx, got):
            out[i] = t
    return out


@torch.no_grad()
def sync_grads(grads: Any, specs: Any, rules) -> Any:
    """Sum each gradient leaf over the batch axes its spec does not cut it
    on (a leaf replicated over them holds only its rank's rows' part;
    a leaf cut over ``fsdp`` was summed by ``gather_fsdp``'s backward):
    one flat psum for all the leaves of one set of axes and one dtype."""
    leaves, spec_leaves = tree.leaves(grads), tree.leaves(specs)
    out = list(leaves)
    groups: dict = {}
    for i, (g, s) in enumerate(zip(leaves, spec_leaves)):
        cut = {a for e in s for a in _axes(e)}
        axes = tuple(a for a in rules.batch if a not in cut)
        if axes and rules.axis_size(axes) > 1:
            groups.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in groups.items():
        flat = rules.comm(axes).psum(torch.cat([leaves[i].reshape(-1)
                                                for i in idx]))
        lo = 0
        for i in idx:
            k = leaves[i].numel()
            out[i] = flat[lo:lo + k].view_as(leaves[i])
            lo += k
    return tree.unflatten(grads, out)


# --------------------------------------------------------------------------
# Rules
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchCut:
    """One rank's place in a batch cut as ``Rules.batch_spec`` says:
    the batch axes the rows are cut over (``()``: every rank holds every
    row), this rank's block among ``parts`` blocks, and ``copies``, the
    replication factor: the size of the batch axes the spec leaves out,
    so that ``parts * copies`` is the batch axes' size."""
    axes: tuple[str, ...]
    index: int
    parts: int
    copies: int

    def take(self, x):
        """This rank's block of ``x`` along its first dim (a view of a
        tensor or an array whose first dim ``parts`` divides; ``x``
        itself when the rows are not cut)."""
        if self.parts == 1:
            return x
        n = x.shape[0] // self.parts
        return x[self.index * n:(self.index + 1) * n]

    def local(self, i: int, size: int) -> int | None:
        """Where row ``i`` of a batch of ``size`` rows sits in this rank's
        block, or None when another rank's block holds it."""
        n = size // self.parts
        return i - self.index * n if i // n == self.index else None


@dataclasses.dataclass(frozen=True)
class Rules:
    """Axis-usage rules for one mesh: the reference's, on any object with
    ``.shape`` (axis name -> size) and ``.axis_names``.  The runtime
    helpers (:meth:`comm`, :meth:`coordinate`) need a
    :class:`~repro_torch.launch.mesh.Mesh`."""
    mesh: Any
    batch: tuple[str, ...] = ("data",)
    model: str = "model"
    fsdp: str = "data"

    # ---- axis sizes -------------------------------------------------------
    def axis_size(self, name: str | tuple[str, ...] | None) -> int:
        if name is None:
            return 1
        if isinstance(name, tuple):
            size = 1
            for n in name:
                size *= self.mesh.shape[n]
            return size
        return self.mesh.shape[name]

    @property
    def dp(self) -> int:
        return self.axis_size(self.batch)

    @property
    def tp(self) -> int:
        return self.axis_size(self.model)

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp

    # ---- divisibility-safe spec atoms --------------------------------------
    def shard_if(self, dim: int, axes: str | tuple[str, ...] | None):
        """``axes`` if ``dim`` divides their product, else None."""
        if axes is None:
            return None
        if dim % self.axis_size(axes) == 0:
            return axes
        return None

    def batch_spec(self, batch_size: int):
        """Best batch-dim sharding: all batch axes, progressively fewer."""
        axes = self.batch
        while axes:
            if batch_size % self.axis_size(axes) == 0:
                return axes if len(axes) > 1 else axes[0]
            axes = axes[1:]
        return None

    def batch_cut(self, batch_size: int) -> BatchCut:
        """This rank's rows of a global batch of ``batch_size`` under
        :meth:`batch_spec`: cut over the axes it keeps (every row when it
        keeps none), replicated over the ones it leaves out."""
        axes = _axes(self.batch_spec(batch_size))
        parts = self.axis_size(axes)
        return BatchCut(axes, self.coordinate(axes) if parts > 1 else 0,
                        parts, self.dp // parts)

    def tokens_spec(self, n_tokens: int):
        """Token dim over batch axes + model axis (flattened (B*S, D))."""
        full = (*self.batch, self.model)
        if n_tokens % self.axis_size(full) == 0:
            return full
        return self.batch_spec(n_tokens)

    # ---- the rank's place and collectives -----------------------------------
    def comm(self, axes) -> Collective:
        return self.mesh.comm(_axes(axes))

    def coordinate(self, axes) -> int:
        return self.mesh.coordinate(_axes(axes))

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def single_pod_rules(mesh) -> Rules:
    return Rules(mesh=mesh, batch=("data",))


def multi_pod_rules(mesh) -> Rules:
    return Rules(mesh=mesh, batch=("pod", "data"))


def rules_for_mesh(mesh) -> Rules:
    """Infer rules from the mesh's axis names."""
    if "pod" in mesh.axis_names:
        return multi_pod_rules(mesh)
    return single_pod_rules(mesh)


def spec_tree_like(params: Any, fn) -> Any:
    """A spec tree of ``params``' structure: ``fn(path, leaf)`` at each
    leaf, ``path`` as ``jax.tree_util.keystr`` names it."""
    pairs = tree.flatten_with_paths(params)
    return tree.unflatten(params, [fn(path, leaf) for path, leaf in pairs])


def local_shard(full: torch.Tensor, spec, rules: Rules) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a view); a dim cut
    over axes that its size does not divide raises, as XLA refuses such a
    sharding."""
    out = full
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = rules.axis_size(axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split over {axes} ({n})")
        step = out.shape[dim] // n
        out = out.narrow(dim, rules.coordinate(axes) * step, step)
    return out


def gather(local: torch.Tensor, spec, rules: Rules,
           axes: Sequence[str] | None = None) -> torch.Tensor:
    """``local`` put back together over the mesh axes its spec names
    (only those in ``axes``, when given): the inverse of
    :func:`local_shard`."""
    out = local
    for dim, entry in enumerate(spec):
        names = _axes(entry)
        if not names or (axes is not None
                         and not set(names) <= set(axes)):
            continue
        out = rules.comm(names).all_gather(out, axis=dim)
    return out


def full_like(local: Any, specs: Any, rules: Rules) -> Any:
    """Meta tensors of the full shapes (and the dtypes) of which ``local``
    holds this rank's slices under ``specs``: the ``like`` of an elastic
    restore, at the current mesh's padding."""
    def one(x, spec):
        shape = [n * rules.axis_size(_axes(e)) for n, e in zip(x.shape, spec)]
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return tree.tree_map(one, local, specs)


def shard_tree(full: Any, specs: Any, rules: Rules) -> Any:
    """Each leaf of ``full`` cut to this rank's slice of its spec, an own
    contiguous copy (the full tree can then go)."""
    leaves = tree.leaves(full)
    spec_leaves = tree.leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return tree.unflatten(full, [
        local_shard(x, s, rules).clone(memory_format=torch.contiguous_format)
        for x, s in zip(leaves, spec_leaves)])


# --------------------------------------------------------------------------
# Data-parallel serving placement
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataParallel:
    """Data-parallel placement: one row shard of every bucket a device of
    ``devices`` (a card may be listed more than once)."""

    devices: tuple[Any, ...]
    kind = "data"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("DataParallel needs at least one device")
        object.__setattr__(self, "devices", tuple(self.devices))

    @classmethod
    def over(cls, n_shards: int, devices: Sequence[Any] | None = None
             ) -> "DataParallel":
        """The first ``n_shards`` of ``devices`` (default: every visible
        card, never the CPU)."""
        devices = tuple(devices if devices is not None else visible_cards())
        if n_shards < 1 or n_shards > len(devices):
            raise ValueError(f"n_shards={n_shards} outside 1.."
                             f"{len(devices)} visible devices")
        return cls(devices[:n_shards])

    @property
    def n_shards(self) -> int:
        return len(self.devices)
