"""Topological graph executor with per-node backend dispatch (DESIGN.md §4.5).

Counterpart of ``repro.runtime.executor``.  Evaluates a
:class:`~repro_torch.runtime.graph.Graph` in its deterministic schedule,
eagerly: each node's work is queued on the current CUDA stream as it is
reached, and nothing waits for the device.  Per-node backends (the table
in :mod:`repro_torch.kernels.ops` pairs each with its JAX mode):

* ``"torch"``            plain PyTorch xor+popcount (always available),
* ``"torch_pm1"``        plain PyTorch +-1 matmul form,
* ``"cuda_pm1"``         im2col + the +-1 tensor-core kernel (K6); the
                         first layer's weighted words through K1,
* ``"cuda_popcount"``    im2col + the fused matmul kernel (K2),
* ``"cuda_direct"``      the direct conv kernel (K3) — conv ops only,
* ``"cuda_direct_pool"`` K3 with the OR-pool fused into its epilogue —
                         ``packed_conv_pool`` nodes only.

``bitplane_expand`` always goes through the bit-plane kernel (K4), and the
unfused count ops of a trained-params graph (``conv_counts``,
``dense_counts``) always go through the count kernel (K1); their float-BN
and pool epilogues (``bn_binarize``, ``threshold_pack``, ``maxpool_pm1``)
are plain PyTorch.

The first layer's filters are the converter's bit-plane copies, so their
counts are one u8 x s8 product (``core.bitplanes``).  For a first-layer
conv on ``cuda_direct``/``cuda_direct_pool``/``cuda_pm1``, and for a
first-layer ``conv_counts``, the executor builds that form once, when it
is built (``bitplanes.plane_filters`` raises if the filters lack the
structure), and the node runs K3's or K1's bit-plane variant.

Above the per-node backends sits the region-level ``"cuda_chain"`` mode
(DESIGN.md §9): the executor accepts ``regions=`` — chains formed by
:mod:`repro_torch.runtime.regions` — and evaluates each whole region in
one K5 launch with on-chip intermediates; member nodes are skipped in the
schedule and nodes outside every region degrade per node along
``_FALLBACK``.

All backends are bit-exact with one another, which is what makes
per-node autotuning (:mod:`repro_torch.runtime.autotune`) safe.  A mode
string that does not apply to an op degrades along ``_FALLBACK``; an
explicit per-node backend that does not apply is rejected.

``tiles`` maps a node to its kernel tile, as the reference's
``tile_configs``: for a ``cuda_direct``/``cuda_direct_pool`` node, K3's
tensor-core tile ``{"tile_h", "tile_w", "nw_block"}`` in place of
``plan_mma``'s pick (the autotuner's sweep).  Tiles change the launch
geometry only, never the result.

:class:`CapturedExecutor` is the counterpart of the reference's compiled
bucket executable: a frozen executor (and, for a workload, its head)
captured at one input shape as one CUDA graph, so a forward's launches
replay in one host call.

The ``executor.call`` fault site (:mod:`repro_torch.obs.inject`) sits
host side at the start of :meth:`GraphExecutor.__call__` (ctx ``nodes``)
and of :meth:`CapturedExecutor.replay` (ctx ``bucket``), never inside a
captured graph.  :meth:`GraphExecutor.traced_call` is the diagnostic
walk: one span a node or region, each closed by a device synchronize.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Mapping, Sequence

import torch

from repro_torch.core import (binary_conv, binary_ops, bitplanes,
                              bnn_model, layer_integration, packing)
from repro_torch.kernels import ops as kops
from repro_torch.obs import inject as _inject
from repro_torch.obs import trace as _trace
from repro_torch.runtime import regions as _regions
from repro_torch.runtime.graph import DISPATCHABLE_OPS, Graph

BACKENDS = ("torch", "torch_pm1", "cuda_pm1", "cuda_popcount", "cuda_direct",
            "cuda_direct_pool")
# The region-level mode: not a per-node backend — chains are evaluated
# whole via ``regions`` — but a valid engine ``matmul_mode``.
CHAIN_BACKEND = "cuda_chain"
ALL_MODES = BACKENDS + (CHAIN_BACKEND,)

# Graceful degradation when a single mode string hits an op it cannot run.
_FALLBACK = {"cuda_chain": "cuda_direct_pool",
             "cuda_direct_pool": "cuda_direct",
             "cuda_direct": "cuda_popcount"}
# Backends whose first-layer conv runs a bit-plane variant (K3's or K1's).
_PLANE_BACKENDS = ("cuda_direct", "cuda_direct_pool", "cuda_pm1")
# Backends that take a per-node tile (K3's tensor-core tile).
TILE_BACKENDS = ("cuda_direct", "cuda_direct_pool")


def valid_backends(op: str) -> tuple[str, ...]:
    """The backends an op can dispatch to."""
    if op == "packed_conv_pool":
        return BACKENDS
    if op == "packed_conv":
        return tuple(b for b in BACKENDS if b != "cuda_direct_pool")
    if op == "packed_dense":
        return ("torch", "torch_pm1", "cuda_pm1", "cuda_popcount")
    return ()


def resolve_backend(op: str, backend: str) -> str:
    """Degrade a requested mode along _FALLBACK until the op supports it."""
    requested = backend
    while backend not in valid_backends(op):
        if backend not in _FALLBACK:
            raise ValueError(
                f"backend {requested!r} unusable for op {op!r}; want one "
                f"of {valid_backends(op)}")
        backend = _FALLBACK[backend]
    return backend


def pool_attrs(a: dict) -> tuple[int, int, tuple[int, int]] | None:
    """A conv+pool node's ``(window, stride, (pad_lo, pad_hi))``, or None."""
    if "pool_window" not in a:
        return None
    return (a["pool_window"], a["pool_stride"],
            tuple(a.get("pool_pad", (0, 0))))


def uses_planes(node, backend: str | None) -> bool:
    """Whether ``node`` runs a bit-plane variant under ``backend``: a
    first-layer node with plane word weights, as a count node or on a
    backend that has the variant."""
    return bool(node.attrs.get("first")) and "word_weights" in node.params \
        and (node.op == "conv_counts" or backend in _PLANE_BACKENDS)


def node_params(node, backend: str | None) -> dict:
    """``node``'s params as ``eval_node`` takes them under ``backend``:
    with the first layer's u8 x s8 filters where the node runs a
    bit-plane variant (``bitplanes.plane_filters`` raises if the filters
    lack the converter's structure)."""
    if not uses_planes(node, backend):
        return node.params
    return dict(node.params, planes=bitplanes.plane_filters(
        node.params["w_packed"], node.params["word_weights"],
        node.attrs["kernel"] ** 2))


def _mma_tile(tile: Mapping[str, int] | None):
    """A K3 tile dict as the kernel wrapper takes it, or None."""
    if not tile:
        return None
    return (tile["tile_h"], tile["tile_w"], tile["nw_block"])


def _eval_packed_conv(a: dict, p: dict, x, backend: str, tile):
    k, s, pad = a["kernel"], a["stride"], a["pad"]
    ww = p.get("word_weights")
    pool = pool_attrs(a)
    planes = p.get("planes")
    mma_tile = _mma_tile(tile) if backend in TILE_BACKENDS else None
    if backend == "cuda_direct_pool":
        # The pool rides the direct kernel's epilogue.
        return kops.fused_binary_conv2d(
            x, p["w_packed"], p["thresh"], k, k, s, pad, word_weights=ww,
            mode="cuda_direct", pool=pool, planes=planes, tile=mma_tile)
    out = kops.fused_binary_conv2d(
        x, p["w_packed"], p["thresh"], k, k, s, pad, word_weights=ww,
        mode=backend, planes=planes, tile=mma_tile)
    if pool is not None:
        out = binary_conv.binary_or_maxpool(out, pool[0], pool[1],
                                            pad=pool[2])
    return out


def _eval_bn_binarize(a: dict, p: dict, cnt: torch.Tensor) -> torch.Tensor:
    """The float-BN epilogue on counts, in float32 with the reference's
    operation order, so its bits equal ``threshold_pack``'s after
    ``integrate_bn``."""
    k_valid = float(a["k_valid"])
    if a.get("first"):
        # wcnt -> Eqn-2 dot: s = 255*(K + w_sum)/2 - wcnt
        const = 255.0 * (k_valid + p["w_sum"].to(torch.float32)) / 2.0
        dot = const - cnt.to(torch.float32)
    else:
        dot = k_valid - 2.0 * cnt.to(torch.float32)
    x3 = bnn_model.bn(dot + p.get("bias", 0.0), p)
    return packing.pack_bits(x3 >= 0, axis=-1)


def _eval_maxpool_pm1(a: dict, x: torch.Tensor) -> torch.Tensor:
    """Semantic max-pool: unpack to +-1, pad with -1, max, repack."""
    xv = packing.unpack_to_pm1(x, a["channels"], dtype=torch.float32)
    xv = bnn_model.max_pool_nhwc(xv, a["window"], a["stride"],
                                 tuple(a.get("pad", (0, 0))))
    return packing.pack_bits(xv >= 0, axis=-1)


def eval_node(node_op: str, attrs: dict, params: dict, inputs: list,
              backend: str = "torch", tile: Mapping[str, int] | None = None):
    """Evaluate one node given its already-computed input values; ``tile``
    (a K3 tile dict) goes to the direct kernel under ``TILE_BACKENDS``."""
    a, p = attrs, params
    if node_op == "bitplane_expand":
        return kops.bitplane_pack(inputs[0])
    if node_op == "conv_counts":
        flat, (n, oh, ow) = binary_conv.im2col_matmul(
            inputs[0], a["kernel"], a["kernel"], a["stride"], a["pad"])
        cnt = kops.matmul_counts(flat, p["w_packed"], p.get("word_weights"),
                                 planes=p.get("planes"),
                                 cw=inputs[0].shape[-1]
                                 // bitplanes.NUM_PLANES)
        return cnt.reshape(n, oh, ow, cnt.shape[-1])
    if node_op == "dense_counts":
        flat = inputs[0].reshape(inputs[0].shape[0], -1)
        return kops.matmul_counts(flat, p["w_packed"])
    if node_op == "bn_binarize":
        return _eval_bn_binarize(a, p, inputs[0])
    if node_op == "threshold_pack":
        return packing.pack_bits(
            layer_integration.apply_threshold(inputs[0], p["thresh"]),
            axis=-1)
    if node_op == "maxpool_pm1":
        return _eval_maxpool_pm1(a, inputs[0])
    if node_op == "concat_packed":
        return torch.cat(inputs, dim=-1)
    if node_op in ("packed_conv", "packed_conv_pool"):
        return _eval_packed_conv(a, p, inputs[0], backend, tile)
    if node_op == "packed_dense":
        return kops.fused_binary_dense(inputs[0], p["w_packed"], p["thresh"],
                                       mode=backend)
    if node_op == "or_pool":
        return binary_conv.binary_or_maxpool(
            inputs[0], a["window"], a["stride"],
            pad=tuple(a.get("pad", (0, 0))))
    if node_op == "unpack_pm1":
        return packing.unpack_to_pm1(inputs[0], a["channels"],
                                     dtype=torch.float32)
    if node_op == "float_dense":
        flat = inputs[0].reshape(inputs[0].shape[0], -1)
        with binary_ops.full_float32():
            return flat @ p["w"] + p["b"]
    if node_op == "float_conv":
        return bnn_model.float_conv_nhwc(inputs[0], p["w"], p["b"],
                                         a["stride"], a["pad"])
    raise ValueError(f"cannot evaluate op {node_op!r}")


def _synced_span(name: str, attrs: dict, fn: Callable, *args, **kw
                 ) -> torch.Tensor:
    """``traced_call``'s per-node wrapper: ``fn`` inside one span that a
    device synchronize closes, stamped with the output's shape."""
    with _trace.span(name, "executor", **attrs) as sp:
        out = fn(*args, **kw)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        sp.set(shape=list(out.shape))
    return out


class GraphExecutor:
    """Topological evaluator with frozen per-node backends, per-node
    tiles and fused regions: serving calls reuse the executor the engine
    built for their bucket."""

    def __init__(self, graph: Graph,
                 backends: str | Mapping[int, str] = "torch",
                 regions: Sequence[_regions.Chain] | None = None,
                 tiles: Mapping[int, Mapping[str, int]] | None = None):
        graph.validate()
        self.graph = graph
        # Fused regions (runtime.regions.Chain): each is evaluated whole
        # when the schedule reaches its head; member nodes are skipped and
        # the result binds to the tail's id.
        self.regions = tuple(regions or ())
        self._region_head = {c.head: c for c in self.regions}
        self._region_members = {nid for c in self.regions
                                for nid in c.node_ids}
        if len(self._region_members) != sum(len(c.node_ids)
                                            for c in self.regions):
            raise ValueError("regions overlap")
        if isinstance(backends, str):
            backends = {nid: resolve_backend(n.op, backends)
                        for nid, n in graph.nodes.items()
                        if n.op in DISPATCHABLE_OPS}
        self.backends: dict[int, str] = {
            nid: b for nid, b in backends.items()
            if graph.nodes[nid].op in DISPATCHABLE_OPS}
        for nid, b in self.backends.items():
            op = graph.nodes[nid].op
            if b not in BACKENDS:
                raise ValueError(f"unknown backend {b!r} for node {nid}; "
                                 f"want one of {BACKENDS}")
            if b not in valid_backends(op):
                raise ValueError(f"backend {b!r} does not apply to node "
                                 f"{nid} ({op})")
        self.tiles: dict[int, dict] = {
            nid: dict(t) for nid, t in (tiles or {}).items()
            if nid in self.backends and t}
        for nid in self.tiles:
            if self.backends[nid] not in TILE_BACKENDS:
                raise ValueError(f"node {nid} on {self.backends[nid]!r} "
                                 f"takes no tile")
        self.params = {str(nid): n.params for nid, n in graph.nodes.items()
                       if n.params}
        # First-layer nodes that run a bit-plane variant: their params with
        # the u8 x s8 filters, built once here.
        self._node_params = {
            nid: node_params(n, self.backends.get(nid))
            for nid, n in graph.nodes.items()
            if nid not in self._region_members
            and uses_planes(n, self.backends.get(nid))}
        self._schedule = graph.topo_order()

    def _run(self, x: torch.Tensor,
             node_span: Callable | None = None) -> torch.Tensor:
        """The schedule walk.  ``node_span`` (``traced_call``'s
        :func:`_synced_span`) wraps each node's or region's evaluation as
        ``node_span(name, attrs, fn, *args, **kw)``; None, the serving
        path, calls ``fn`` directly."""
        g = self.graph
        env: dict[int, torch.Tensor] = {}
        for nid in self._schedule:
            node = g.nodes[nid]
            if node.op == "input":
                env[nid] = x
                continue
            if nid in self._region_members:
                if nid in self._region_head:
                    chain = self._region_head[nid]
                    args = (chain, self.params, env[node.inputs[0]])
                    env[chain.tail] = (
                        _regions.eval_chain(*args) if node_span is None
                        else node_span(
                            "region." + "+".join(map(str, chain.node_ids)),
                            dict(op="chain", stages=len(chain.stages)),
                            _regions.eval_chain, *args))
                continue
            args = (node.op, node.attrs,
                    self._node_params.get(nid, node.params),
                    [env[i] for i in node.inputs])
            backend = self.backends.get(nid, "torch")
            tile = self.tiles.get(nid)
            env[nid] = (
                eval_node(*args, backend=backend, tile=tile)
                if node_span is None
                else node_span(f"node.{node.op}",
                               dict(node=nid,
                                    backend=self.backends.get(nid)),
                               eval_node, *args, backend=backend, tile=tile))
        return env[g.output_id]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # Fault site, host side before any launch; disabled, one read.
        if _inject._PLAN is not None:
            _inject.maybe_fault("executor.call", nodes=len(self._schedule))
        # The disabled-tracing fast path is one global read.
        if _trace._TRACER is None:
            return self._run(x)
        with _trace.span("executor.call", "runtime",
                         nodes=len(self._schedule),
                         regions=len(self.regions)):
            return self._run(x)

    def traced_call(self, x: torch.Tensor) -> torch.Tensor:
        """The schedule walked node by node, one span per node
        (``node.<op>``) or region (``region.<ids>``), each closed by a
        device synchronize so its duration is the node's own time.  The
        same walk as :meth:`__call__`, so bit-exact with it; a
        diagnostic, never captured and never a serving path (the
        synchronizes forfeit all overlap)."""
        with _trace.span("executor.traced_call", "runtime",
                         nodes=len(self._schedule)):
            return self._run(x, node_span=_synced_span)

    def backend_report(self) -> list[dict]:
        """One row per dispatchable node outside every region, and one per
        region (``op="chain"``), in schedule order, each with its tile."""
        rows = []
        for nid in self._schedule:
            node = self.graph.nodes[nid]
            if nid in self._region_members:
                chain = self._region_head.get(nid)
                if chain is not None:
                    rows.append(dict(
                        node="+".join(map(str, chain.node_ids)), op="chain",
                        channels=self.graph.nodes[chain.tail]
                                     .attrs.get("channels"),
                        backend=CHAIN_BACKEND, tile=dict(chain.tile)))
                continue
            if nid in self.backends:
                rows.append(dict(node=nid, op=node.op,
                                 channels=node.attrs.get("channels"),
                                 backend=self.backends[nid],
                                 tile=dict(self.tiles.get(nid, {}))))
        return rows


# --------------------------------------------------------------------------
# CUDA-graph capture
# --------------------------------------------------------------------------

#: Eager calls on a side stream before a capture.  The first does every
#: first-use piece of host work a capture cannot hold: it builds and loads
#: the kernel library, sets each kernel's shared-memory attribute, fills
#: the tile planners' caches, queries K5's cluster occupancy and builds its
#: operands; the second runs with all of that done, as the PyTorch
#: CUDA-graphs notes prescribe.
WARMUP_CALLS = 2


def capture(fn: Callable, args: tuple, device: torch.device, *,
            pool=None, warmup: int = WARMUP_CALLS):
    """Run ``fn(*args)`` ``warmup`` times on a side stream, then capture one
    call as a CUDA graph into the memory pool ``pool``.  Returns (graph,
    what the captured call returned: its static output).  A capture that
    fails raises; nothing falls back to eager calls.

    The capture is ``thread_local``: a serving thread may capture a
    demoted bucket's rung while an abandoned watchdog reader still waits
    on an earlier batch's event in another thread, and the default
    ``global`` mode would make that reader's CUDA call void the
    capture.  The cyclic garbage collector waits until the capture ends:
    a collection inside it could free an unreachable object that owns
    another graph (a server or a replica group left in a reference
    cycle), and destroying a graph while the stream captures voids the
    capture."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = fn(*args)
    finally:
        if collecting:
            gc.enable()
    return graph, out


class Captured:
    """What the server stages into and replays: a bucket captured as CUDA
    graphs reading ``static_input`` and leaving ``static_outputs``, with
    the frozen ``executor`` inside.  Subclasses define :meth:`replay`
    (queued on the current stream; returns ``static_output``)."""

    executor: GraphExecutor | None
    static_input: torch.Tensor
    static_outputs: tuple[torch.Tensor, ...]
    static_output: torch.Tensor

    def replay(self) -> torch.Tensor:
        raise NotImplementedError

    def run(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Copies of every output of one replay on ``x``."""
        self.static_input.copy_(x)
        self.replay()
        return tuple(t.clone() for t in self.static_outputs)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.static_input.copy_(x)
        return self.replay().clone()

    @property
    def n_graphs(self) -> int:
        return 1

    def backend_report(self) -> list[dict]:
        return self.executor.backend_report()


class CapturedExecutor(Captured):
    """A frozen executor captured at one input shape (DESIGN.md §12).

    ``fn`` maps a batch of ``input_shape`` (``input_dtype``: uint8 images,
    or a pipeline stage's boundary words) to a tensor, or to a tuple
    whose first element is the output and whose others are kept for the
    caller to read (a workload bucket keeps the forward's raw output
    beside its decoded rows).  Construction warms ``fn`` up and captures
    it reading a static input buffer; graphs of one engine share a memory
    pool (``pool``, from ``torch.cuda.graph_pool_handle()``).

    A graph's outputs live in the pool: a later replay of any graph of
    that pool may overwrite them.  So :meth:`__call__` returns copies, and
    a caller of :meth:`replay` (the server, staging into
    ``static_input``) queues its copy of the output on the same stream
    before the next replay.  ``executor`` is the frozen
    :class:`GraphExecutor` inside, for introspection."""

    def __init__(self, fn: Callable, input_shape: Sequence[int],
                 device: torch.device, *, pool=None,
                 executor: GraphExecutor | None = None,
                 warmup: int = WARMUP_CALLS,
                 input_dtype: torch.dtype = torch.uint8):
        self.executor = executor
        self.static_input = torch.zeros(tuple(input_shape),
                                        dtype=input_dtype, device=device)
        t0 = time.perf_counter()
        with torch.no_grad():
            self.graph, out = capture(fn, (self.static_input,), device,
                                      pool=pool, warmup=warmup)
        self.capture_s = time.perf_counter() - t0
        self.static_outputs = out if isinstance(out, tuple) else (out,)
        self.static_output = self.static_outputs[0]

    def replay(self) -> torch.Tensor:
        """Replay on the current stream; returns the static output (see
        the class docstring for how long it holds)."""
        if _inject._PLAN is not None:
            _inject.maybe_fault("executor.call",
                                bucket=self.static_input.shape[0])
        if _trace._TRACER is None:
            self.graph.replay()
        else:
            with _trace.span("executor.call", "runtime", captured=True,
                             bucket=self.static_input.shape[0]):
                self.graph.replay()
        return self.static_output
