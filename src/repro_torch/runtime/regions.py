"""Chain-fusion region formation (DESIGN.md §9).

Counterpart of ``repro.runtime.regions``.  Partitions a scheduled graph
into maximal *chains* — linear runs of packed ops (``packed_conv`` /
``packed_conv_pool`` / ``or_pool`` / ``maxpool_pm1`` on packed input) —
that the executor's ``cuda_chain`` mode runs as one K5 launch each
(:mod:`repro_torch.kernels.chain_conv`), with the intermediates in the
block's shared memory at planner-assigned offsets.  Only each chain's
entry and exit touch device memory.

Region-formation rules (§9.1), as in the reference:

* ops must be chainable (the set above; ``maxpool_pm1`` only when its
  input is already packed words, where it is exactly an OR-pool);
* the run must be a pure path: every non-tail member has exactly one
  consumer, the next member;
* the chain's on-chip plan must fit the budget; a run that does not is
  split greedily — the longest fitting prefix becomes a region and the
  cut boundary goes through device memory;
* runs shorter than ``min_nodes`` (default 2) stay on the per-node path.

Nodes in no region run per node along the executor's fallback order.

**The budget on Hopper.**  An H100 block can hold at most 227 KB of
shared memory (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 232,448 B),
so ``DEFAULT_SMEM_BUDGET`` is that.  What counts against it is what the
CUDA kernel keeps in shared memory: the interior arena and nothing else
— the entry, the filters, word weights and thresholds are read from
device memory through L1/L2, and the counts live in registers.  So
:func:`plan_chain_vmem` returns the reference's ``offsets``, ``sizes`` and
``arena_bytes`` with ``fixed_bytes = 0``.  The reference adds the entry
tile, every stage's weights, the final tile and the popcount accumulator
to ``fixed_bytes``, because Pallas holds those operand blocks in VMEM;
under 227 KB that formula forms no region at all for the paper nets.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.kernels.chain_conv import (ChainOperands, StageSpec,
                                            chain_geometry, chain_operands,
                                            chain_word_counts)
from repro_torch.runtime.graph import (PACKED_OPS, Graph, TensorType,
                                       infer_types)
from repro_torch.runtime.memory import VmemPlan, vmem_plan

# The H100's opt-in shared memory per block; chip_smoke.py checks it
# against the card.
DEFAULT_SMEM_BUDGET = 227 * 1024

CHAIN_OPS = frozenset({"packed_conv", "packed_conv_pool", "or_pool",
                       "maxpool_pm1"})


def node_stages(node) -> tuple[StageSpec, ...]:
    """Lower one graph node to its kernel stage(s); ``packed_conv_pool``
    decomposes into a conv and a pool stage (inside a chain the conv
    output goes to the arena either way)."""
    a = node.attrs
    if node.op in ("packed_conv", "packed_conv_pool"):
        stages = [StageSpec("conv", kernel=a["kernel"], stride=a["stride"],
                            pad_lo=a["pad"], pad_hi=a["pad"],
                            channels=a["channels"],
                            first=bool(a.get("first")))]
        if node.op == "packed_conv_pool":
            plo, phi = tuple(a.get("pool_pad", (0, 0)))
            stages.append(StageSpec("pool", kernel=a["pool_window"],
                                    stride=a["pool_stride"],
                                    pad_lo=plo, pad_hi=phi,
                                    channels=a["channels"]))
        return tuple(stages)
    if node.op in ("or_pool", "maxpool_pm1"):
        plo, phi = tuple(a.get("pad", (0, 0)))
        return (StageSpec("pool", kernel=a["window"], stride=a["stride"],
                          pad_lo=plo, pad_hi=phi,
                          channels=a.get("channels") or 0),)
    raise ValueError(f"op {node.op!r} is not chainable")


@dataclasses.dataclass
class Chain:
    """One fused region: schedule-ordered member nodes, their static
    kernel stages, the head's input shape, the arena plan at the default
    tile, and the tile config."""
    node_ids: tuple[int, ...]
    stages: tuple[StageSpec, ...]
    in_shape: tuple[int, ...]
    plan: VmemPlan
    tile: dict = dataclasses.field(default_factory=dict)
    # Kernel-layout operands, built on first use (see ``operands``).
    _operands: tuple | None = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def head(self) -> int:
        return self.node_ids[0]

    @property
    def tail(self) -> int:
        return self.node_ids[-1]

    def arena(self, tile: Mapping[str, int] | None = None
              ) -> tuple[tuple[int, ...], int]:
        """(int32-element offsets per interior stage output, arena words)
        for a tile config (the tile changes the interior sizes)."""
        plan = plan_chain_vmem(self.stages, self.in_shape,
                               tile=dict(tile if tile is not None
                                         else self.tile))
        return (tuple(o // 4 for o in plan.offsets), plan.arena_bytes // 4)

    def hbm_bytes_avoided(self) -> int:
        """Whole-map device-memory traffic the fusion removes: one store and
        one load per interior stage boundary."""
        return stages_hbm_bytes_avoided(self.stages, self.in_shape)

    def signature_key(self) -> tuple:
        """Shape/op identity of the chain (for a tile cache)."""
        return (tuple(dataclasses.astuple(st) for st in self.stages),
                tuple(self.in_shape))

    def operands(self, params_by_node: Mapping[str, Mapping]
                 ) -> ChainOperands:
        """The members' params in the kernel's layout (filters padded and
        transposed), built once and reused while the params are the same
        tensors."""
        arrays = chain_stage_arrays(self, params_by_node)
        key = tuple(id(a) for a in arrays)
        if self._operands is None or self._operands[0] != key:
            self._operands = (key, chain_operands(self.stages, arrays))
        return self._operands[1]


def stages_hbm_bytes_avoided(stages: Sequence[StageSpec],
                             in_shape: Sequence[int]) -> int:
    """One store + one load of every interior stage output at full-map
    size — the boundary traffic a fused chain never issues."""
    n, h, w = in_shape[0], in_shape[1], in_shape[2]
    cws = chain_word_counts(tuple(stages), in_shape[3])
    total = 0
    for k, st in enumerate(stages[:-1]):
        h, w = st.out_size(h), st.out_size(w)
        total += 2 * n * h * w * cws[k + 1] * 4
    return total


def plan_chain_vmem(stages: Sequence[StageSpec], in_shape: Sequence[int],
                    *, tile: Mapping[str, int] | None = None,
                    budget: int | None = None) -> VmemPlan:
    """The shared-memory plan for one chain at one tile config: interior
    stage tiles (lifetime [k, k+1]) go through the planner's first-fit.
    ``fixed_bytes`` is 0: the CUDA kernel keeps nothing else in shared
    memory (module docstring)."""
    tile = dict(tile or {})
    n, h, w, cw0 = in_shape
    bn = max(1, min(tile.get("block_n", 1), n))
    geo = chain_geometry(tuple(stages), h, w, tile.get("block_h"),
                         tile.get("block_w"))
    cws = chain_word_counts(tuple(stages), cw0)
    sizes = [4 * bn * th * tw * cws[k + 1]
             for k, (th, tw) in enumerate(geo.out_tile[:-1])]
    return vmem_plan(sizes, budget=budget, fixed_bytes=0)


def build_chain(graph: Graph, node_ids: Sequence[int],
                input_shape: Sequence[int],
                types: Mapping[int, TensorType] | None = None,
                budget: int | None = None) -> Chain:
    """Assemble a :class:`Chain` from explicit member ids (a valid path of
    chainable ops)."""
    types = types if types is not None else infer_types(
        graph, tuple(input_shape))
    node_ids = tuple(node_ids)
    stages: list[StageSpec] = []
    for nid in node_ids:
        stages.extend(node_stages(graph.nodes[nid]))
    in_shape = types[graph.nodes[node_ids[0]].inputs[0]].shape
    plan = plan_chain_vmem(stages, in_shape, budget=budget)
    return Chain(node_ids=node_ids, stages=tuple(stages),
                 in_shape=in_shape, plan=plan)


def _chainable(graph: Graph, nid: int) -> bool:
    node = graph.nodes[nid]
    if node.op not in CHAIN_OPS:
        return False
    if node.op == "maxpool_pm1":
        return graph.nodes[node.inputs[0]].op in PACKED_OPS
    return True


def partition_chains(graph: Graph, input_shape: Sequence[int],
                     *, vmem_budget: int | None = DEFAULT_SMEM_BUDGET,
                     min_nodes: int = 2,
                     types: Mapping[int, TensorType] | None = None
                     ) -> list[Chain]:
    """Partition the schedule into maximal budget-fitting chains."""
    types = types if types is not None else infer_types(
        graph, tuple(input_shape))
    cons = graph.consumers()
    used: set[int] = set()
    runs: list[list[int]] = []
    for nid in graph.topo_order():
        if nid in used or not _chainable(graph, nid):
            continue
        run = [nid]
        used.add(nid)
        cur = nid
        while len(cons[cur]) == 1:
            nxt = cons[cur][0]
            if (nxt in used or not _chainable(graph, nxt)
                    or graph.nodes[nxt].inputs != (cur,)):
                break
            run.append(nxt)
            used.add(nxt)
            cur = nxt
        runs.append(run)

    chains: list[Chain] = []
    for run in runs:
        start = 0
        while start < len(run):
            # Longest prefix whose plan fits the budget.
            best = None
            for end in range(start + 1, len(run) + 1):
                cand = build_chain(graph, run[start:end], input_shape,
                                   types=types, budget=vmem_budget)
                if not cand.plan.fits():
                    break
                best = cand
            if best is None:          # even a single node busts the budget
                start += 1
                continue
            if len(best.node_ids) >= min_nodes:
                chains.append(best)
            start += len(best.node_ids)
    return chains


def chain_stage_arrays(chain: Chain, params_by_node: Mapping[str, Mapping]
                       ) -> tuple:
    """Flatten member-node params into the reference's per-conv-stage
    tuple ``(w_packed, word_weights | None, threshold, sign_flip)``."""
    arrays: list = []
    for nid in chain.node_ids:
        p = params_by_node.get(str(nid), {})
        if "w_packed" not in p:
            continue                               # pool node: no params
        thr = p["thresh"]
        arrays += [p["w_packed"], p.get("word_weights"),
                   thr.threshold, thr.sign_flip]
    return tuple(arrays)


def eval_chain(chain: Chain, params_by_node: Mapping[str, Mapping],
               x: torch.Tensor) -> torch.Tensor:
    """Run one region through K5 (dispatched via :mod:`repro_torch.kernels.
    ops`), with the planner's arena offsets."""
    from repro_torch.kernels import ops as kops

    offsets, words = chain.arena(chain.tile)
    return kops.chain_forward(
        x, chain.stages, chain.operands(params_by_node),
        arena_offsets=offsets, arena_words=words, **chain.tile)


def chain_executor(graph: Graph, input_shape: Sequence[int],
                   *, vmem_budget: int | None = DEFAULT_SMEM_BUDGET,
                   tuner=None):
    """The region-fused executor: partition the schedule into
    budget-fitting chains, optionally sweep each chain's tile with an
    :class:`~repro_torch.runtime.autotune.Autotuner` (``tune_chains``,
    which keeps a tile only if it fits the chain's budget; without one
    every chain runs at the whole-map tile), and freeze them into a
    :class:`~repro_torch.runtime.executor.GraphExecutor` whose leftover
    per-node ops degrade along the normal fallback order."""
    from repro_torch.runtime.executor import CHAIN_BACKEND, GraphExecutor

    chains = partition_chains(graph, input_shape, vmem_budget=vmem_budget)
    if tuner is not None:
        tuner.tune_chains(graph, chains)
    return GraphExecutor(graph, CHAIN_BACKEND, regions=chains)


def chain_report(chains: Sequence[Chain]) -> list[dict]:
    """One row per region: members, stage count, arena plan, the device
    traffic it avoids."""
    return [dict(nodes="+".join(map(str, c.node_ids)),
                 n_stages=len(c.stages),
                 in_shape="x".join(map(str, c.in_shape)),
                 arena_bytes=c.plan.arena_bytes,
                 vmem_bytes=c.plan.total_bytes(),
                 hbm_bytes_avoided=c.hbm_bytes_avoided(),
                 tile=dict(c.tile))
            for c in chains]
