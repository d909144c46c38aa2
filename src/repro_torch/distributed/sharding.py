"""Mesh-axis sharding rules for the LM stack, their collectives, and the
data-parallel serving placement (DESIGN.md §13).

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

import dataclasses
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
    pinned host memory and back."""

    # Bytes of the tensors this process has handed to collectives of more
    # than one rank (each call's input once), for the smoke's accounting.
    payload_bytes = 0

    def __init__(self, group, size: int, index: int, staged: bool = False):
        self.group, self.size, self.index = group, size, index
        self.staged = staged

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        Collective.payload_bytes += x.numel() * x.element_size()
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

    def _reduce(self, x, op) -> torch.Tensor:
        if self.size == 1:
            return x
        h = self._host(x)
        if h is x:
            h = x.clone()
        dist.all_reduce(h, op=op, group=self.group)
        return self._back(h, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``axis`` in rank order
        (``lax.all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return x
        h = self._host(x)
        buf = self._like(h, (self.size, *h.shape))
        dist.all_gather(list(buf.unbind(0)), h, group=self.group)
        return torch.cat(self._back(buf, x).unbind(0), dim=axis)

    def all_to_all(self, x: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``:
        ``split_axis`` cut into ``size`` blocks, block j sent to rank j,
        the blocks received concatenated along ``concat_axis`` in rank
        order."""
        if self.size == 1:
            return x
        n = self.size
        moved = x.movedim(split_axis, 0)
        if moved.shape[0] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} does not split over {n}")
        blocks = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:])
        h = self._host(blocks)
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


# --------------------------------------------------------------------------
# Rules
# --------------------------------------------------------------------------

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
