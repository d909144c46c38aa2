"""Per-node backend + tile autotuning (DESIGN.md §4.6, §5.4).

Counterpart of ``repro.runtime.autotune``.  Every executor backend is
bit-exact, so the fastest one a node is a free win, and which one is
fastest depends on the node's shape.  :class:`Autotuner` times each
candidate backend on a zero-filled input of the node's inferred shape on
the engine's device — the median wall time of ``iters`` calls after
``warmup``, each closed by a device synchronize, so the launch's host
cost counts, as it does when serving — and caches the winner under a
shape/attr/candidate/device signature.  The winners are frozen into a
:class:`~repro_torch.runtime.executor.GraphExecutor`, so serving never
re-times.

**Candidates.**  On the card, the ``cuda_*`` backends only: a plain
PyTorch backend never wins a node there (:func:`default_candidates`).
Off the card, the two plain backends, as the reference tunes only its
XLA forms off the TPU.  For ``cuda_direct`` / ``cuda_direct_pool`` the
kernel's tile is part of the search: K3's tensor-core tile ``(tile_h,
tile_w, nw_block)``, swept over ``plan_mma``'s pick and the next three
tiles by its cost model (:func:`tile_candidates`); the other backends
keep their planners and have no per-node tile.

**Buckets.**  Each fresh measurement is also recorded under a batchless
signature (the batch dim a placeholder).  A miss at a new batch size
first consults it: a winner whose tile does not span the batch (no
``block_n``; K3 tiles never do) is adopted without re-timing
(``xfer_hit``, the entry marked ``reused_across_batch``).

**Regions.**  :meth:`Autotuner.tune_chains` sweeps each fused region's
final tile (whole map, a few row splits, a batch-spanning tile;
:func:`chain_tile_candidates`), filtered by the region's shared-memory
budget, and caches winners under ``chain::`` signatures.

**Persistence.**  Winners persist to ``~/.cache/repro_torch/
autotune.json`` under the same signatures, each stamped with the torch
and CUDA versions and the device (:func:`entry_env_ok`): an entry stamped
by another toolchain or card (or by the JAX package) is a ``disk_miss``
and is re-timed.  ``REPRO_AUTOTUNE_CACHE=0`` turns persistence off; any
other value is the cache file's path.

Each decision bumps an ``autotune.{hit,disk_hit,disk_miss,xfer_hit,miss}``
counter and records an ``autotune`` event in the process registry; each
sweep is an ``autotune.sweep`` span.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import bitplanes
from repro_torch.kernels import direct_conv_bn_binarize as _k3
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _trace
from repro_torch.runtime.executor import (BACKENDS, TILE_BACKENDS,
                                          GraphExecutor, eval_node,
                                          node_params, pool_attrs,
                                          uses_planes, valid_backends)
from repro_torch.runtime.graph import DISPATCHABLE_OPS, Graph, infer_types

_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
_DEFAULT_CACHE = "~/.cache/repro_torch/autotune.json"

# The plain PyTorch backends: contenders off the card only.
PLAIN_BACKENDS = ("torch", "torch_pm1")


def default_candidates(device) -> tuple[str, ...]:
    """The ``cuda_*`` backends on a CUDA device, the plain ones
    elsewhere."""
    if torch.device(device).type == "cuda":
        return tuple(b for b in BACKENDS if b not in PLAIN_BACKENDS)
    return PLAIN_BACKENDS


def cache_path() -> pathlib.Path | None:
    """Resolved on-disk cache location; None when persistence is off."""
    val = os.environ.get(_CACHE_ENV)
    if val == "0":
        return None
    if val:
        return pathlib.Path(val).expanduser()
    return pathlib.Path(_DEFAULT_CACHE).expanduser()


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def env_stamp(device) -> dict:
    """The stamp every persisted entry carries: the torch and CUDA
    versions and the device it was measured on."""
    device = torch.device(device)
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": _device_name(device)}


def entry_env_ok(entry, device) -> bool:
    """Whether a persisted entry was measured under this process's
    toolchain on this kind of device (an unstamped entry, or one the JAX
    package stamped, is stale by definition)."""
    return isinstance(entry, dict) and entry.get("env") == env_stamp(device)


def _device_kind(device: torch.device) -> str:
    """The concrete device (e.g. 'cuda:NVIDIA H100 80GB HBM3'): winners
    tuned on one card must not warm-start another."""
    return f"{device.type}:{_device_name(device)}"


def _node_signature(node, in_shape: tuple, candidates: tuple[str, ...],
                    device: torch.device) -> str:
    """Stable string key: op + static attrs + shapes + candidate set +
    device kind (a string, so the cache round-trips through JSON)."""
    attrs = tuple(sorted((k, v) for k, v in node.attrs.items()
                         if isinstance(v, (int, bool, str, tuple))))
    pshapes = tuple(sorted(
        (k, tuple(np.shape(v))) for k, v in node.params.items()
        if not hasattr(v, "_fields")))
    return repr((node.op, attrs, tuple(in_shape), pshapes, candidates,
                 _device_kind(device)))


def _agnostic_signature(node, in_shape: tuple, candidates: tuple[str, ...],
                        device: torch.device) -> str:
    """:func:`_node_signature` with the batch dim a placeholder, so that
    winners transfer across serving buckets."""
    return "batchless::" + _node_signature(
        node, ("B",) + tuple(in_shape[1:]), candidates, device)


def _k3_call(backend: str, node, in_shape: tuple):
    """K3's planner arguments ``((n, fh, fw, o), geometry)`` for a node on
    a direct backend, or None where the node takes the word-weighted
    CUDA-core kernel (no tile)."""
    planes = uses_planes(node, backend)
    if "word_weights" in node.params and not planes:
        return None
    a = node.attrs
    n, h, w, cw = in_shape
    pool = pool_attrs(a) if backend == "cuda_direct_pool" else None
    _, _, fh, fw = _k3.conv_geometry(h, w, a["kernel"], a["kernel"],
                                     a["stride"], a["pad"], pool)
    geo = dict(kh=a["kernel"], kw=a["kernel"], stride=a["stride"],
               cw=cw // bitplanes.NUM_PLANES if planes else cw, pool=pool,
               planes=planes)
    return (n, fh, fw, node.params["w_packed"].shape[0]), geo


def tile_candidates(backend: str, node, in_shape: tuple,
                    limits: _k3.MmaLimits | None) -> list[dict]:
    """K3 tiles to time for a node on a direct backend: ``plan_mma``'s
    pick first, then the next three distinct tiles of ``mma_candidates``
    by its cost model.  Every other backend, a word-weighted node and a
    device without the card's limits (``limits`` None) get ``[{}]``:
    the backend's own planner."""
    call = _k3_call(backend, node, in_shape) \
        if backend in TILE_BACKENDS and limits is not None else None
    if call is None:
        return [{}]
    args, geo = call
    pick = _k3.plan_mma(*args, **geo, limits=limits)
    ranked = sorted(_k3.mma_candidates(*args, **geo, limits=limits),
                    key=lambda c: (c[0], -c[1].tile_h * c[1].tile_w,
                                   -c[1].nw_block))
    out: list[dict] = []
    for plan in [pick] + [p for _, p in ranked]:
        tile = dict(tile_h=plan.tile_h, tile_w=plan.tile_w,
                    nw_block=plan.nw_block)
        if tile not in out:
            out.append(tile)
        if len(out) == 4:
            break
    return out


def label(backend: str, tile: dict) -> str:
    """A sweep entry's name: the backend and its tile, if any."""
    if not tile:
        return backend
    return f"{backend}[" + ",".join(f"{k}={v}"
                                    for k, v in sorted(tile.items())) + "]"


def _tuning_event(outcome: str, op: str, key: str, entry: dict) -> None:
    """One tuning decision in the process registry: an
    ``autotune.<outcome>`` counter bump and an ``autotune`` event with the
    signature and, for a fresh sweep, how many candidates were timed."""
    reg = _obs_metrics.get_registry()
    reg.counter(f"autotune.{outcome}").inc()
    reg.event("autotune", outcome=outcome, op=op, signature=key,
              sweep_size=(len(entry.get("timings_ms", {}))
                          if outcome == "miss" else 0))


def _chain_signature(chain, device: torch.device) -> str:
    """Chain-shaped cache key (stage specs + head input shape + device
    kind), ``chain::``-prefixed so per-node and per-chain records share
    one cache without colliding."""
    return "chain::" + repr((chain.signature_key(), _device_kind(device)))


def chain_tile_candidates(chain) -> list[dict]:
    """A region's final-tile sweep: the whole map (the default), row
    splits of 4, 8, 16 and half the map, and a batch-spanning tile, each
    kept only if the region's shared-memory plan still fits its budget."""
    from repro_torch.kernels.chain_conv import chain_geometry
    from repro_torch.runtime.regions import plan_chain_vmem

    n, h, w = chain.in_shape[0], chain.in_shape[1], chain.in_shape[2]
    fh = chain_geometry(chain.stages, h, w, None, None).final_hw[0]
    cands: list[dict] = [{}]
    seen = {fh}
    for bh in (4, 8, 16, max(1, fh // 2)):
        eff = min(bh, fh)
        if eff not in seen:
            seen.add(eff)
            cands.append({"block_h": eff})
    if n > 1:
        cands.append({"block_n": n})
    return [t for t in cands
            if plan_chain_vmem(chain.stages, chain.in_shape, tile=t,
                               budget=chain.plan.budget).fits()]


class Autotuner:
    """Times candidates once per node signature on ``device``; caches
    winners in memory and (by default) on disk."""

    def __init__(self, cache: dict | None = None,
                 candidates: Iterable[str] | None = None,
                 warmup: int = 1, iters: int = 3, persist: bool = True,
                 agnostic_cache: dict | None = None,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.cache: dict = cache if cache is not None else {}
        # batchless winners, kept out of ``cache`` so that it stays one
        # entry per node signature.
        self.agnostic_cache: dict = (agnostic_cache
                                     if agnostic_cache is not None else {})
        self.candidates = tuple(candidates if candidates is not None
                                else default_candidates(self.device))
        for c in self.candidates:
            if c not in BACKENDS:
                raise ValueError(f"unknown candidate backend {c!r}")
        self.warmup = warmup
        self.iters = iters
        # persist=False forces fresh measurements and writes nothing.
        self.persist = persist
        self._disk: dict = self._load_disk() if persist else {}

    # ---- persistence -----------------------------------------------------
    def _load_disk(self) -> dict:
        path = cache_path()
        if path is None or not path.exists():
            return {}
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _save_disk(self, new_entries: dict) -> None:
        path = cache_path()
        if path is None or not new_entries or not self.persist:
            return
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            merged = dict(self._load_disk())
            merged.update(new_entries)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            self._disk = merged
        except OSError:
            pass  # persistence is best-effort; tuning already succeeded

    def _env_ok(self, entry) -> bool:
        return entry_env_ok(entry, self.device)

    # ---- measurement -----------------------------------------------------
    def _median_s(self, fn) -> float:
        """Median wall seconds of ``iters`` calls of ``fn`` after
        ``warmup``, each closed by a device synchronize."""
        cuda = self.device.type == "cuda"
        for _ in range(self.warmup):
            fn()
            if cuda:
                torch.cuda.synchronize(self.device)
        times = []
        for _ in range(self.iters):
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    def _time_node(self, node, x, backend: str, tile: dict) -> float:
        params = node_params(node, backend)
        return self._median_s(lambda: eval_node(
            node.op, node.attrs, params, [x], backend=backend, tile=tile))

    def _limits(self) -> _k3.MmaLimits | None:
        if self.device.type != "cuda":
            return None
        return _k3.mma_limits(self.device)

    def _tune_node(self, node, in_shape, in_dtype) -> dict:
        x = torch.zeros(in_shape, dtype=in_dtype, device=self.device)
        timings: dict[str, float] = {}
        best = (float("inf"), None, {})
        for backend in self.candidates:
            if backend not in valid_backends(node.op):
                continue
            for tile in tile_candidates(backend, node, in_shape,
                                        self._limits()):
                t = self._time_node(node, x, backend, tile)
                timings[label(backend, tile)] = t
                if t < best[0]:
                    best = (t, backend, tile)
        if best[1] is None:
            raise ValueError(
                f"no candidate in {self.candidates} applies to op "
                f"{node.op!r}")
        return dict(winner=best[1], tile=best[2],
                    timings_ms={lbl: round(t * 1e3, 4)
                                for lbl, t in timings.items()},
                    env=env_stamp(self.device))

    def entry(self, node, in_shape: tuple) -> dict | None:
        """The cached tuning record of a node signature, if any."""
        return self.cache.get(_node_signature(node, in_shape,
                                              self.candidates, self.device))

    def chain_entry(self, chain) -> dict | None:
        """The cached tuning record of a chain, if any."""
        return self.cache.get(_chain_signature(chain, self.device))

    def tune(self, graph: Graph, input_shape: tuple) -> dict[int, str]:
        """Pick a backend per dispatchable node; returns the backend map
        (:meth:`tune_with_tiles` also returns the per-node tiles)."""
        return self.tune_with_tiles(graph, input_shape)[0]

    def _cross_batch_entry(self, akey: str) -> dict | None:
        """A winner measured at another batch size, if transferable (a
        disk record must also pass the toolchain stamp)."""
        entry = self.agnostic_cache.get(akey)
        if entry is None:
            disk = self._disk.get(akey)
            if disk is not None and self._env_ok(disk):
                entry = disk
        if entry and not (entry.get("tile") or {}).get("block_n"):
            return entry
        return None

    def tune_with_tiles(self, graph: Graph, input_shape: tuple
                        ) -> tuple[dict[int, str], dict[int, dict]]:
        types = infer_types(graph, tuple(input_shape))
        choices: dict[int, str] = {}
        tiles: dict[int, dict] = {}
        fresh: dict[str, dict] = {}
        for nid in graph.topo_order():
            node = graph.nodes[nid]
            if node.op not in DISPATCHABLE_OPS:
                continue
            in_t = types[node.inputs[0]]
            key = _node_signature(node, in_t.shape, self.candidates,
                                  self.device)
            akey = _agnostic_signature(node, in_t.shape, self.candidates,
                                       self.device)
            if key in self.cache:
                outcome = "hit"             # warm in-memory winner
            elif key in self._disk and self._env_ok(self._disk[key]):
                self.cache[key] = self._disk[key]
                outcome = "disk_hit"        # a prior run, same toolchain
            elif key in self._disk:
                # Tuned under another toolchain or card: re-sweep.
                _tuning_event("disk_miss", node.op, key, self._disk[key])
                with _trace.span("autotune.sweep", "autotune", op=node.op):
                    self.cache[key] = fresh[key] = self._tune_node(
                        node, in_t.shape, in_t.dtype)
                outcome = "miss"
            elif (xfer := self._cross_batch_entry(akey)) is not None:
                # Measured at another bucket; no batch-spanning tile.
                self.cache[key] = dict(xfer, reused_across_batch=True)
                outcome = "xfer_hit"
            else:
                with _trace.span("autotune.sweep", "autotune", op=node.op):
                    self.cache[key] = fresh[key] = self._tune_node(
                        node, in_t.shape, in_t.dtype)
                outcome = "miss"
            entry = self.cache[key]
            _tuning_event(outcome, node.op, key, entry)
            if akey not in self.agnostic_cache and \
                    not entry.get("reused_across_batch"):
                record = {k: v for k, v in entry.items()
                          if k != "reused_across_batch"}
                self.agnostic_cache[akey] = record
                if key in fresh:
                    fresh[akey] = record
            choices[nid] = entry["winner"]
            tile = entry.get("tile") or {}
            if tile:
                tiles[nid] = dict(tile)
        self._save_disk(fresh)
        return choices, tiles

    def tuned_executor(self, graph: Graph, input_shape: tuple
                       ) -> GraphExecutor:
        choices, tiles = self.tune_with_tiles(graph, input_shape)
        return GraphExecutor(graph, choices, tiles=tiles)

    # ---- chain (region) tuning -------------------------------------------
    def _time_chain(self, chain, stage_arrays, x, tile: dict) -> float:
        from repro_torch.kernels import ops as kops

        offs, words = chain.arena(tile)
        return self._median_s(lambda: kops.chain_forward(
            x, chain.stages, stage_arrays, arena_offsets=offs,
            arena_words=words, **tile))

    def _tune_chain(self, chain, graph: Graph) -> dict:
        arrays = chain.operands({str(nid): graph.nodes[nid].params
                                 for nid in chain.node_ids})
        x = torch.zeros(chain.in_shape, dtype=torch.int32,
                        device=self.device)
        timings: dict[str, float] = {}
        best = (float("inf"), {})
        for tile in chain_tile_candidates(chain):
            t = self._time_chain(chain, arrays, x, tile)
            timings[label("cuda_chain", tile)] = t
            if t < best[0]:
                best = (t, tile)
        return dict(winner="cuda_chain", tile=best[1],
                    timings_ms={lbl: round(t * 1e3, 4)
                                for lbl, t in timings.items()},
                    env=env_stamp(self.device))

    def tune_chains(self, graph: Graph, chains) -> None:
        """Pick a tile per chain (set in place on ``chain.tile``); winners
        cache and persist under ``chain::`` signatures."""
        from repro_torch.runtime.regions import plan_chain_vmem

        fresh: dict[str, dict] = {}
        for chain in chains:
            key = _chain_signature(chain, self.device)
            if key in self.cache:
                outcome = "hit"
            elif key in self._disk and self._env_ok(self._disk[key]):
                self.cache[key] = self._disk[key]
                outcome = "disk_hit"
            else:
                if key in self._disk:
                    _tuning_event("disk_miss", "chain", key,
                                  self._disk[key])
                with _trace.span("autotune.sweep", "autotune", op="chain"):
                    self.cache[key] = fresh[key] = self._tune_chain(
                        chain, graph)
                outcome = "miss"
            _tuning_event(outcome, "chain", key, self.cache[key])
            tile = dict(self.cache[key].get("tile") or {})
            # The signature does not hold the budget: a winner cached
            # under a larger one may not fit this chain's, and then the
            # whole map (which region formation proved fits) runs.
            if tile and not plan_chain_vmem(chain.stages, chain.in_shape,
                                            tile=tile,
                                            budget=chain.plan.budget
                                            ).fits():
                tile = {}
            chain.tile = tile
        self._save_disk(fresh)
