"""Multi-device placement on the runtime IR (DESIGN.md §13).

Counterpart of ``repro.runtime.placement``.  The placement pass maps one
serving graph onto several devices; two placement kinds share it, and
the serving layer duck-types them on ``.kind`` (it never imports
:mod:`repro_torch.distributed`):

* **pipeline** — the schedule is cut into contiguous stages, one
  executor per stage on its device, with the boundary tensor moved to
  the next stage's device between them
  (:class:`~repro_torch.distributed.pipeline.Pipelined`);
* **data** — the padded bucket is split into equal row shards, one
  executor per shard device at ``bucket // n``, and the rows are gathered
  on the first device (:class:`~repro_torch.distributed.sharding.
  DataParallel`).  The reference runs this as one XLA executable over a
  mesh; torch has no such executable, so the port runs the shards itself
  (:class:`ShardedExecutor`).

Pipeline cuts are legal only at the graph's device-memory touch points: a
schedule position where exactly one live value crosses the cut.  Under
``cuda_chain`` the pass also refuses to cut inside a region, whose
intermediates never leave the block's shared memory; the forbidden
interiors come from :func:`~repro_torch.runtime.regions.partition_chains`
at ``DEFAULT_SMEM_BUDGET``.  Cuts are chosen by the reference's DP, which
minimises the heaviest stage under the same static cost model, so the
plan (stages, boundaries, costs) equals the reference's on the same
graph.

Stage boundaries and row shards are exact handoffs, so a placed forward
equals the single-device one bit for bit, and its kernel launches summed
over stages or shards are the single-device forward's (a region is never
split).  A device list may name one card more than once: the stages then
run in order on that card's current stream, which is the reference's
"degenerate-but-useful" single-device case.

On the card the engine captures a placed bucket as one CUDA graph per
stage (or shard) on its device — a graph cannot span devices — in that
device's graph pool: :class:`CapturedStages` copies each boundary into
the next stage's static input between replays, :class:`CapturedShards`
copies the row shards in and the outputs back into buffers on the first
device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Sequence

import torch

from repro_torch.core.binary_conv import conv_out_size
from repro_torch.runtime import executor as _executor
from repro_torch.runtime import regions as _regions
from repro_torch.runtime.graph import Graph, Node, TensorType, infer_types

_CONV_OPS = ("packed_conv", "packed_conv_pool", "conv_counts")


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def node_cost(node: Node, types: Mapping[int, TensorType]) -> float:
    """Static work estimate for one node (relative units), as the
    reference's: conv and dense ops count xor-popcount MACs (output
    positions x kernel area x input words), everything else its output
    bytes."""
    t = types[node.id]
    a = node.attrs
    if node.op in _CONV_OPS:
        # Pre-pool dims: a conv+pool node's output type is the pooled map.
        in_t = types[node.inputs[0]]
        oh = conv_out_size(in_t.shape[1], a["kernel"], a["stride"],
                           a["pad"])
        ow = conv_out_size(in_t.shape[2], a["kernel"], a["stride"],
                           a["pad"])
        return float(oh * ow * a["kernel"] * a["kernel"] * in_t.shape[-1]
                     * a["channels"] * t.shape[0])
    if node.op in ("packed_dense", "dense_counts", "float_dense"):
        in_t = types[node.inputs[0]]
        k = 1
        for d in in_t.shape[1:]:
            k *= d
        return float(k * a["channels"] * t.shape[0])
    if node.op == "float_conv":
        in_t = types[node.inputs[0]]
        return float(t.shape[1] * t.shape[2] * a["kernel"] * a["kernel"]
                     * in_t.shape[-1] * a["channels"] * t.shape[0])
    return float(t.nbytes)


# ---------------------------------------------------------------------------
# Cut candidates
# ---------------------------------------------------------------------------

def cut_candidates(graph: Graph,
                   forbidden: frozenset[int] | set[int] = frozenset()
                   ) -> list[tuple[int, int]]:
    """Legal cut positions as ``(schedule_index, boundary_id)``: a cut
    after ``schedule[i]`` is legal when exactly one live value crosses it
    and neither that value nor the next node is in ``forbidden`` (region
    interiors)."""
    schedule = graph.topo_order()
    pos = {nid: i for i, nid in enumerate(schedule)}
    cons = graph.consumers()
    out: list[tuple[int, int]] = []
    for i in range(len(schedule) - 1):
        live = [nid for nid in schedule[:i + 1]
                if any(pos[c] > i for c in cons[nid])
                or nid == graph.output_id]
        if len(live) != 1:
            continue
        boundary = live[0]
        if boundary in forbidden or schedule[i + 1] in forbidden:
            continue
        out.append((i, boundary))
    return out


def chain_interiors(chains: Sequence[_regions.Chain]) -> frozenset[int]:
    """Node ids inside a region (every member but the tail): a cut there
    would split an activation that never reaches device memory.  Tails
    stay legal boundaries."""
    ids: set[int] = set()
    for c in chains:
        ids.update(c.node_ids[:-1])
    return frozenset(ids)


# ---------------------------------------------------------------------------
# Stage planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A pipeline partition of one graph's schedule: ``stages`` (node ids
    per stage, contiguous, schedule order), ``boundaries`` (the producer
    shipped across each cut) and ``costs`` (cost-model total a stage)."""
    stages: tuple[tuple[int, ...], ...]
    boundaries: tuple[int, ...]
    costs: tuple[float, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def report(self) -> list[dict]:
        total = sum(self.costs) or 1.0
        return [dict(stage=i, nodes=list(ids), cost=cost,
                     share=round(cost / total, 4),
                     boundary=(self.boundaries[i]
                               if i < len(self.boundaries) else None))
                for i, (ids, cost) in enumerate(zip(self.stages,
                                                    self.costs))]


def plan_pipeline(graph: Graph, input_shape: Sequence[int],
                  n_stages: int, *,
                  forbidden: frozenset[int] | set[int] = frozenset(),
                  types: Mapping[int, TensorType] | None = None
                  ) -> StagePlan:
    """Cut the schedule into at most ``n_stages`` stages among
    :func:`cut_candidates`, minimising the heaviest stage's cost (the
    reference's DP).  A graph with fewer legal cuts gets fewer stages,
    not an error."""
    graph.validate()
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    types = types if types is not None else infer_types(
        graph, tuple(input_shape))
    schedule = graph.topo_order()
    costs = [node_cost(graph.nodes[nid], types) for nid in schedule]
    cands = cut_candidates(graph, forbidden)
    k = min(n_stages - 1, len(cands))
    if k == 0:
        return StagePlan((tuple(schedule),), (), (sum(costs),))

    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def seg(a: int, b: int) -> float:
        """Cost of schedule[a..b] inclusive."""
        return prefix[b + 1] - prefix[a]

    n = len(schedule)
    positions = [p for p, _ in cands]
    # best[j][ci]: the least heaviest-stage cost with j cuts, the last at
    # candidate ci.
    best = [[float("inf")] * len(positions) for _ in range(k + 1)]
    back = [[-1] * len(positions) for _ in range(k + 1)]
    for ci, p in enumerate(positions):
        best[1][ci] = seg(0, p)
    for j in range(2, k + 1):
        for ci, p in enumerate(positions):
            for pi in range(ci):
                if positions[pi] >= p:
                    continue
                cand = max(best[j - 1][pi], seg(positions[pi] + 1, p))
                if cand < best[j][ci]:
                    best[j][ci] = cand
                    back[j][ci] = pi
    final_best, final_ci = float("inf"), -1
    for ci, p in enumerate(positions):
        cand = max(best[k][ci], seg(p + 1, n - 1))
        if cand < final_best:
            final_best, final_ci = cand, ci
    chosen: list[int] = []
    j, ci = k, final_ci
    while j >= 1 and ci >= 0:
        chosen.append(ci)
        ci = back[j][ci]
        j -= 1
    chosen.reverse()
    cut_pos = [positions[c] for c in chosen]
    boundary = dict(cands)

    stages: list[tuple[int, ...]] = []
    stage_costs: list[float] = []
    start = 0
    for p in cut_pos + [n - 1]:
        stages.append(tuple(schedule[start:p + 1]))
        stage_costs.append(seg(start, p))
        start = p + 1
    boundaries = tuple(boundary[p] for p in cut_pos)
    for ids, b in zip(stages, boundaries):
        assert b in ids, (b, ids)   # produced by its own stage
    return StagePlan(tuple(stages), boundaries, tuple(stage_costs))


# ---------------------------------------------------------------------------
# Stage subgraphs
# ---------------------------------------------------------------------------

def stage_subgraph(graph: Graph, node_ids: Sequence[int],
                   boundary_in: int | None, device=None,
                   dtype: torch.dtype | None = None) -> Graph:
    """One stage as a graph of its own.  ``boundary_in`` (the previous
    stage's boundary producer) becomes an ``input`` placeholder that keeps
    its node id, so every edge inside the stage survives; ``dtype`` (the
    boundary's, a port addition) makes ``infer_types`` give the
    placeholder its real element type.  With ``device`` the node params go
    there through :meth:`Graph.to`, which keeps a tensor already on it."""
    g = Graph(input_hw=graph.input_hw)
    if boundary_in is not None:
        src = graph.nodes[boundary_in]
        attrs = dict(channels=src.attrs.get("channels"))
        if dtype is not None:
            attrs["dtype"] = dtype
        g.nodes[boundary_in] = Node(boundary_in, "input", (), attrs=attrs)
        g.input_id = boundary_in
    for nid in node_ids:
        n = graph.nodes[nid]
        g.nodes[nid] = Node(nid, n.op, n.inputs, dict(n.attrs),
                            dict(n.params))
        if n.op == "input":
            g.input_id = nid
    g.output_id = node_ids[-1]
    g.validate()
    return g if device is None else g.to(device)


def _stage_executor(sub: Graph, shape: tuple, mode: str, tuner
                    ) -> _executor.GraphExecutor:
    """One stage's (or shard's) executor: the engine's choice for
    ``mode``."""
    if mode == _executor.CHAIN_BACKEND:
        return _regions.chain_executor(sub, shape, tuner=tuner)
    if mode == "auto":
        if tuner is None:
            raise ValueError("mode='auto' needs a tuner")
        return tuner.tuned_executor(sub, shape)
    return _executor.GraphExecutor(sub, mode)


# ---------------------------------------------------------------------------
# Staged (pipeline-parallel) executor
# ---------------------------------------------------------------------------

class StagedExecutor:
    """One executor per stage with the boundary moved between devices
    (DESIGN.md §13).

    The :class:`GraphExecutor` serve surface (``__call__``, ``graph``,
    ``regions``, ``backend_report``), so the engine's bucket cache and the
    server's dispatch work unchanged.  A call walks the stages: the
    boundary goes to the stage's device with ``.to(device,
    non_blocking=True)``, then the stage's executor queues its kernels.
    ``tuner`` is one per device (``tuner(device)``) or None."""

    def __init__(self, graph: Graph, input_shape: Sequence[int],
                 devices: Sequence[Any], *, mode: str = "torch",
                 tuner: Callable[[torch.device], Any] | None = None):
        if not devices:
            raise ValueError("pipeline placement needs >= 1 device")
        self.graph = graph
        self.mode = mode
        types = infer_types(graph, tuple(input_shape))
        forbidden: frozenset[int] = frozenset()
        if mode == _executor.CHAIN_BACKEND:
            forbidden = chain_interiors(_regions.partition_chains(
                graph, tuple(input_shape),
                vmem_budget=_regions.DEFAULT_SMEM_BUDGET, types=types))
        self.plan = plan_pipeline(graph, input_shape, len(devices),
                                  forbidden=forbidden, types=types)
        self.devices = tuple(torch.device(d)
                             for d in devices[:self.plan.n_stages])
        # Each stage's input (shape, dtype): the image, then each
        # boundary.
        self.stage_inputs: list[tuple[tuple, torch.dtype]] = []
        self._stage_exes: list[_executor.GraphExecutor] = []
        shape, dtype = tuple(input_shape), torch.uint8
        for i, ids in enumerate(self.plan.stages):
            dev = self.devices[i]
            boundary_in = self.plan.boundaries[i - 1] if i else None
            sub = stage_subgraph(graph, ids, boundary_in, device=dev,
                                 dtype=dtype if i else None)
            self._stage_exes.append(_stage_executor(
                sub, shape, mode, tuner(dev) if tuner else None))
            self.stage_inputs.append((shape, dtype))
            if i < len(self.plan.boundaries):
                t = types[self.plan.boundaries[i]]
                shape, dtype = t.shape, t.dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for dev, exe in zip(self.devices, self._stage_exes):
            x = exe(x.to(dev, non_blocking=True))
        return x

    @property
    def regions(self) -> tuple:
        return tuple(r for e in self._stage_exes for r in e.regions)

    @property
    def stage_executors(self) -> tuple:
        return tuple(self._stage_exes)

    def backend_report(self) -> list[dict]:
        return [dict(row, stage=i, device=str(dev))
                for i, (dev, exe) in enumerate(zip(self.devices,
                                                   self._stage_exes))
                for row in exe.backend_report()]

    def stage_report(self) -> list[dict]:
        """The placement, one row a stage: nodes, static cost and share,
        device, the boundary shipped downstream."""
        rows = self.plan.report()
        for row, dev in zip(rows, self.devices):
            row["device"] = str(dev)
        return rows


def staged_executor(graph: Graph, input_shape: Sequence[int],
                    devices: Sequence[Any], *, mode: str = "torch",
                    tuner=None) -> StagedExecutor:
    """The pipeline executor for ``graph`` over ``devices`` (the engine's
    ``compile(pipeline=...)`` entry point)."""
    return StagedExecutor(graph, input_shape, devices, mode=mode,
                          tuner=tuner)


# ---------------------------------------------------------------------------
# Sharded (data-parallel) executor
# ---------------------------------------------------------------------------

class ShardedExecutor:
    """The data-parallel bucket: rows split into ``len(devices)`` equal
    shards, one executor per distinct device at the shard's batch (params
    on that device with ``.to``), outputs gathered on ``devices[0]``.
    Rows are independent in every op, so the gathered rows equal the
    single-device forward's."""

    def __init__(self, graph: Graph, input_shape: Sequence[int],
                 devices: Sequence[Any], *, mode: str = "torch",
                 tuner: Callable[[torch.device], Any] | None = None):
        n = len(devices)
        if n < 1 or input_shape[0] % n:
            raise ValueError(f"bucket {input_shape[0]} does not split into "
                             f"{n} shards")
        self.graph = graph
        self.mode = mode
        self.devices = tuple(torch.device(d) for d in devices)
        self.shard_shape = (input_shape[0] // n, *input_shape[1:])
        by_device: dict[torch.device, _executor.GraphExecutor] = {}
        for dev in self.devices:
            if dev not in by_device:
                by_device[dev] = _stage_executor(
                    graph.to(dev), self.shard_shape, mode,
                    tuner(dev) if tuner else None)
        self._shard_exes = [by_device[d] for d in self.devices]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = self.shard_shape[0]
        outs = [exe(x[i * m:(i + 1) * m].to(dev, non_blocking=True))
                for i, (dev, exe) in enumerate(zip(self.devices,
                                                   self._shard_exes))]
        return torch.cat([o.to(self.devices[0], non_blocking=True)
                          for o in outs])

    @property
    def regions(self) -> tuple:
        return self._shard_exes[0].regions

    @property
    def shard_executors(self) -> tuple:
        return tuple(self._shard_exes)

    def backend_report(self) -> list[dict]:
        return [dict(row, shard=i, device=str(dev))
                for i, (dev, exe) in enumerate(zip(self.devices,
                                                   self._shard_exes))
                for row in exe.backend_report()]


# ---------------------------------------------------------------------------
# CUDA-graph capture of placed buckets
# ---------------------------------------------------------------------------

def _with_head(fn: Callable, head: Callable | None) -> Callable:
    """``fn`` with ``head`` composed on: (head rows, raw output)."""
    if head is None:
        return fn

    def forward_and_head(x):
        raw = fn(x)
        return head(raw), raw
    return forward_and_head


class CapturedStages(_executor.Captured):
    """A :class:`StagedExecutor` captured as one CUDA graph a stage, each
    on its device into ``pool(device)``; the head rides the last stage's
    graph.  A replay replays each stage and copies its output into the next
    stage's static input, queued in order, so the output a stage leaves
    in its pool is read before a later replay can overwrite it.  A first
    stage that holds the graph's input alone (the plan may cut right after
    it) launches nothing and is not captured: the image goes straight
    into the next stage's static input."""

    def __init__(self, staged: StagedExecutor, head: Callable | None,
                 pool: Callable[[torch.device], Any]):
        self.executor = staged
        last = len(staged.stage_executors) - 1
        t0 = time.perf_counter()
        self.stages: list[_executor.CapturedExecutor] = []
        for i, (dev, exe, (shape, dtype)) in enumerate(zip(
                staged.devices, staged.stage_executors,
                staged.stage_inputs)):
            if exe.graph.output_id == exe.graph.input_id:
                continue                # the input alone: nothing to run
            with torch.cuda.device(dev):
                self.stages.append(_executor.CapturedExecutor(
                    _with_head(exe, head if i == last else None), shape,
                    dev, pool=pool(dev), executor=exe, input_dtype=dtype))
        self.capture_s = time.perf_counter() - t0
        self.static_input = self.stages[0].static_input
        self.static_outputs = self.stages[-1].static_outputs
        self.static_output = self.static_outputs[0]

    @property
    def n_graphs(self) -> int:
        return len(self.stages)

    def replay(self) -> torch.Tensor:
        prev = None
        for st in self.stages:
            if prev is not None:
                st.static_input.copy_(prev, non_blocking=True)
            with torch.cuda.device(st.static_input.device):
                prev = st.replay()
        return self.static_output


class CapturedShards(_executor.Captured):
    """A :class:`ShardedExecutor` captured as one CUDA graph a shard (the
    head composed per shard: heads are row-wise), each on its device into
    ``pool(device)``.  ``static_input`` holds the whole bucket on the
    first device; a replay copies each shard's rows into its graph's
    static input, replays it, and copies its outputs into the gathered
    buffers on the first device (allocated outside every pool)."""

    def __init__(self, sharded: ShardedExecutor, head: Callable | None,
                 pool: Callable[[torch.device], Any]):
        self.executor = sharded
        bucket = sharded.shard_shape[0] * len(sharded.devices)
        t0 = time.perf_counter()
        self.shards: list[_executor.CapturedExecutor] = []
        for dev, exe in zip(sharded.devices, sharded.shard_executors):
            with torch.cuda.device(dev):
                self.shards.append(_executor.CapturedExecutor(
                    _with_head(exe, head), sharded.shard_shape, dev,
                    pool=pool(dev), executor=exe))
        self.capture_s = time.perf_counter() - t0
        first = sharded.devices[0]
        self.static_input = torch.zeros((bucket, *sharded.shard_shape[1:]),
                                        dtype=torch.uint8, device=first)
        self.static_outputs = tuple(
            torch.empty((bucket, *t.shape[1:]), dtype=t.dtype, device=first)
            for t in self.shards[0].static_outputs)
        self.static_output = self.static_outputs[0]

    @property
    def n_graphs(self) -> int:
        return len(self.shards)

    def replay(self) -> torch.Tensor:
        m = self.executor.shard_shape[0]
        for i, st in enumerate(self.shards):
            rows = slice(i * m, (i + 1) * m)
            st.static_input.copy_(self.static_input[rows], non_blocking=True)
            with torch.cuda.device(st.static_input.device):
                st.replay()
            for dst, src in zip(self.static_outputs, st.static_outputs):
                dst[rows].copy_(src, non_blocking=True)
        return self.static_output

