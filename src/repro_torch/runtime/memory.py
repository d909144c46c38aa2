"""Static memory planner for scheduled graphs (DESIGN.md §4.4).

Counterpart of ``repro.runtime.memory``.  With the schedule fixed (the
deterministic topological order) every intermediate has a known byte
size and a known lifetime [birth, last use], so buffers whose lifetimes
do not overlap can share arena space.  :func:`plan_memory` assigns every
intermediate of a graph an offset by lifetime-aware first-fit;
:func:`vmem_plan` runs the same first-fit over one fused chain's interior
stage outputs, and its offsets are where the chain kernel
(:mod:`repro_torch.kernels.chain_conv`) stores and reloads each stage in
its shared-memory arena.

The names (``vmem_plan``, ``VmemPlan``) are the reference's; on the card
the arena is a block's dynamic shared memory, not TPU VMEM.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.runtime.graph import Graph, TensorType, infer_types

# Bytes.  The reference aligns to one VREG row; keeping its value keeps the
# offsets equal to the reference's.  On the card, 128 B is one
# shared-memory wavefront and one L2 sector group.
_ALIGN = 128


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@dataclasses.dataclass(frozen=True)
class BufferPlan:
    node_id: int
    op: str
    shape: tuple[int, ...]
    nbytes: int          # aligned size reserved in the arena
    offset: int          # arena offset
    birth: int           # schedule index of the producing node
    death: int           # schedule index of the last consumer


@dataclasses.dataclass
class MemoryPlan:
    schedule: list[int]
    buffers: dict[int, BufferPlan]
    arena_bytes: int

    def peak_bytes(self) -> int:
        """Arena size: peak intermediate memory under slot reuse."""
        return self.arena_bytes

    def naive_bytes(self) -> int:
        """Sum of all intermediate buffers (the no-reuse baseline)."""
        return sum(b.nbytes for b in self.buffers.values())

    def live_peak_bytes(self) -> int:
        """Lower bound: max over schedule steps of live-buffer bytes."""
        peak = 0
        for t in range(len(self.schedule)):
            live = sum(b.nbytes for b in self.buffers.values()
                       if b.birth <= t <= b.death)
            peak = max(peak, live)
        return peak

    def report(self) -> list[dict]:
        return [dict(node=b.node_id, op=b.op,
                     shape="x".join(map(str, b.shape)), bytes=b.nbytes,
                     offset=b.offset, birth=b.birth, death=b.death)
                for b in sorted(self.buffers.values(), key=lambda b: b.birth)]


def _first_fit(intervals: list[tuple[int, int, int, int]]
               ) -> tuple[dict[int, int], int]:
    """Lifetime-aware first-fit over ``(birth, death, size, key)`` rows:
    place each buffer at the lowest offset that does not collide with an
    already-placed buffer of overlapping lifetime.  Returns
    ``(offsets_by_key, arena_size)``."""
    placed: list[tuple[int, int, int, int]] = []  # (offset, size, birth, death)
    offsets: dict[int, int] = {}
    arena = 0
    for birth, death, size, key in sorted(intervals):
        overlapping = sorted(
            (off, sz) for off, sz, b2, d2 in placed
            if not (d2 < birth or b2 > death))
        offset = 0
        for off, sz in overlapping:
            if offset + size <= off:
                break
            offset = max(offset, off + sz)
        placed.append((offset, size, birth, death))
        offsets[key] = offset
        arena = max(arena, offset + size)
    return offsets, arena


def plan_memory(graph: Graph, input_shape: tuple[int, ...],
                types: dict[int, TensorType] | None = None) -> MemoryPlan:
    """Lifetime analysis + first-fit arena assignment over the schedule.

    The graph input and output are excluded from the arena (the caller
    owns them); every other node output is an intermediate eligible for
    reuse.  On the per-node path the plan is advisory: PyTorch's caching
    allocator places the tensors.
    """
    types = types if types is not None else infer_types(graph, input_shape)
    schedule = graph.topo_order()
    pos = {nid: t for t, nid in enumerate(schedule)}
    cons = graph.consumers()

    intervals: list[tuple[int, int, int, int]] = []  # (birth, death, size, id)
    for nid in schedule:
        if nid in (graph.input_id, graph.output_id):
            continue
        death = max((pos[u] for u in cons[nid]), default=pos[nid])
        intervals.append((pos[nid], death, _align(types[nid].nbytes), nid))

    offsets, arena = _first_fit(intervals)
    buffers = {
        nid: BufferPlan(node_id=nid, op=graph.nodes[nid].op,
                        shape=types[nid].shape, nbytes=size,
                        offset=offsets[nid], birth=birth, death=death)
        for birth, death, size, nid in intervals
    }
    return MemoryPlan(schedule=schedule, buffers=buffers, arena_bytes=arena)


@dataclasses.dataclass(frozen=True)
class VmemPlan:
    """The on-chip arena plan for one fused chain.

    ``offsets``/``arena_bytes`` describe the chain's interior
    intermediates (one per stage boundary, in chain order);
    ``fixed_bytes`` is whatever else the chain kernel keeps on chip, which
    counts against the budget but lies outside the planned arena.
    """
    offsets: tuple[int, ...]     # byte offset per interior intermediate
    sizes: tuple[int, ...]       # aligned byte size per intermediate
    arena_bytes: int             # planned arena extent (0 when no interior)
    fixed_bytes: int             # non-arena on-chip bytes the chain holds
    budget: int | None           # byte budget this plan was checked against

    def total_bytes(self) -> int:
        return self.arena_bytes + self.fixed_bytes

    def fits(self) -> bool:
        return self.budget is None or self.total_bytes() <= self.budget

    def naive_bytes(self) -> int:
        """No-reuse sum of the interior intermediates."""
        return sum(self.sizes)


def vmem_plan(sizes: Sequence[int], *, budget: int | None = None,
              fixed_bytes: int = 0) -> VmemPlan:
    """Plan one chain's arena.  ``sizes[i]`` is the byte size of stage i's
    output tile, produced at chain step i and consumed at step i+1, so
    lifetimes are ``[i, i+1]`` and buffers i and i+2 may share space."""
    intervals = [(i, i + 1, _align(sz), i) for i, sz in enumerate(sizes)]
    offsets, arena = _first_fit(intervals)
    return VmemPlan(
        offsets=tuple(offsets[i] for i in range(len(sizes))),
        sizes=tuple(_align(sz) for sz in sizes),
        arena_bytes=arena, fixed_bytes=fixed_bytes, budget=budget)
