"""Executable artifacts: pay the tuning and planning cost offline
(DESIGN.md §12).

Counterpart of ``repro.serving.artifact``.  The reference serializes each
bucket's compiled XLA executable, so a fresh process serves with zero
traces.  A CUDA graph cannot leave the process that captured it, so this
artifact stores what a fresh process needs in order to capture without
tuning, planning or building: each bucket's frozen executor as a plan
(per-node backends, per-node K3 tiles, and the fused regions, each with
its node ids and tile), the autotune winner table and a meta block.
:func:`load_artifact` rebuilds each bucket's
:class:`~repro_torch.runtime.executor.GraphExecutor` from its plan — no
tuner call, no region planning — and on the card captures it, so after a
load the tuner records no ``miss``, no nvcc build runs (the library is
built once per source hash) and ``build_count`` stays flat while
requests flow.

Artifact layout (one directory)::

    artifact/
      meta.json        schema + provenance + compat fields + bucket index
                       (each plan's file and sha256)
      autotune.json    the tuner's winner table (exact + batchless +
                       chain:: keys), as the reference writes it
      b{N}.plan.json   bucket N's frozen executor

Compatibility policy, as the reference's: an *environment* mismatch on
any :data:`COMPAT_FIELDS` entry — schema, device kind, torch and CUDA
versions, the kernel library's source hash, engine mode, graph
fingerprint, donation and data-parallel flags — degrades **per bucket** to
the live compile path, recorded as an ``artifact`` event with
``outcome="miss"`` and counted on ``artifact.miss``.  An *integrity*
failure — checksum mismatch, unparsable or missing plan, a plan that
names a node or backend the graph lacks — raises :class:`ArtifactError`.

The donation and data-parallel fields are constants here: the port
always stages a batch into the bucket's static input (its counterpart of
a donated input) and serves on one card, so it writes ``donate_input``
true and ``data_parallel`` 1, the only export the reference allows too.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _trace
from repro_torch.runtime import executor as _executor
from repro_torch.runtime import regions as _regions

ARTIFACT_SCHEMA = "phonebit-torch-artifact-v1"
_META = "meta.json"
_AUTOTUNE = "autotune.json"

#: The meta fields a loading process must match bucket for bucket; a
#: mismatch on any of them is a per-bucket ``artifact.miss``, never an
#: error.
COMPAT_FIELDS = ("schema", "device_kind", "torch", "cuda", "kernels", "mode",
                 "fingerprint", "donate_input", "data_parallel")


class ArtifactError(RuntimeError):
    """An artifact is unreadable or fails integrity checks (bad checksum,
    unparsable or missing plan, a plan that does not fit the graph).
    Environment mismatches are NOT errors — they fall back per bucket."""


# ---------------------------------------------------------------------------
# meta / fingerprints
# ---------------------------------------------------------------------------

def _device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _shape_dtype(v) -> tuple[tuple[int, ...], str]:
    if torch.is_tensor(v):
        return tuple(v.shape), str(v.dtype).removeprefix("torch.")
    a = np.asarray(v)
    return tuple(a.shape), str(a.dtype)


def graph_fingerprint(graph) -> str:
    """Stable digest of the serving graph's *structure*: ops, static
    attrs, edges, and parameter shapes/dtypes (not values — weights stay
    live in the loading engine).  A change to the lowering changes the
    fingerprint, so a stale plan misses instead of naming the wrong
    nodes."""
    rows = []
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        attrs = tuple(sorted(
            (k, v) for k, v in node.attrs.items()
            if isinstance(v, (int, bool, str, tuple))))
        pshapes = []
        for k, v in sorted(node.params.items()):
            if hasattr(v, "_fields"):           # IntegratedParams
                for f in v._fields:
                    pshapes.append((k + "." + f,
                                    *_shape_dtype(getattr(v, f))))
            else:
                pshapes.append((k, *_shape_dtype(v)))
        rows.append((nid, node.op, attrs, tuple(node.inputs),
                     tuple(pshapes)))
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def _want_env(engine) -> dict:
    return {
        "schema": ARTIFACT_SCHEMA,
        "device_kind": _device_kind(engine.device),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernels": _build.library_path().name,
        "mode": engine.matmul_mode,
        "fingerprint": graph_fingerprint(engine._graph),
        "donate_input": True,
        "data_parallel": 1,
    }


def _sha256(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


# ---------------------------------------------------------------------------
# bucket plans
# ---------------------------------------------------------------------------

def executor_plan(exe: _executor.GraphExecutor) -> dict:
    """A frozen executor as JSON: per-node backends and K3 tiles, and the
    regions with their node ids and tile."""
    return {
        "backends": {str(nid): b for nid, b in exe.backends.items()},
        "tiles": {str(nid): dict(t) for nid, t in exe.tiles.items()},
        "regions": [{"node_ids": list(c.node_ids), "tile": dict(c.tile)}
                    for c in exe.regions],
    }


def executor_from_plan(graph, plan: dict, input_shape: tuple,
                       name: str = "plan") -> _executor.GraphExecutor:
    """Rebuild a frozen executor from :func:`executor_plan`'s JSON: the
    regions are assembled from their recorded node ids and tiles (no
    partitioning, no tuning).  A plan that does not fit ``graph`` raises
    :class:`ArtifactError`."""
    try:
        backends = {int(nid): b for nid, b in plan["backends"].items()}
        tiles = {int(nid): dict(t) for nid, t in plan["tiles"].items()}
        region_rows = [(tuple(int(i) for i in r["node_ids"]), dict(r["tile"]))
                       for r in plan["regions"]]
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise ArtifactError(f"artifact {name} is malformed: "
                            f"{type(e).__name__}: {e}") from e
    named = set(backends) | set(tiles) | {i for ids, _ in region_rows
                                          for i in ids}
    missing = sorted(named - set(graph.nodes))
    if missing:
        raise ArtifactError(f"artifact {name} names nodes {missing} the "
                            f"graph lacks")
    unknown = sorted({b for b in backends.values()
                      if b not in _executor.BACKENDS})
    if unknown:
        raise ArtifactError(f"artifact {name} names backends {unknown} the "
                            f"executor lacks")
    try:
        chains = []
        for ids, tile in region_rows:
            chain = _regions.build_chain(
                graph, ids, input_shape,
                budget=_regions.DEFAULT_SMEM_BUDGET)
            chain.tile = tile
            if not _regions.plan_chain_vmem(
                    chain.stages, chain.in_shape, tile=tile,
                    budget=_regions.DEFAULT_SMEM_BUDGET).fits():
                raise ValueError(f"region {ids} at tile {tile} does not "
                                 f"fit the shared-memory budget")
            chains.append(chain)
        return _executor.GraphExecutor(graph, backends, regions=chains,
                                       tiles=tiles)
    except (KeyError, ValueError) as e:
        raise ArtifactError(f"artifact {name} does not fit the graph: "
                            f"{e}") from e


def _read_plan(path: pathlib.Path, want_sha: str) -> dict:
    """Integrity-checked read of one bucket plan."""
    if not path.exists():
        raise ArtifactError(f"artifact plan missing: {path}")
    got_sha = _sha256(path)
    if got_sha != want_sha:
        raise ArtifactError(
            f"artifact plan corrupted: {path.name} sha256 {got_sha[:12]} "
            f"!= recorded {want_sha[:12]}")
    try:
        return json.loads(path.read_text())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ArtifactError(f"artifact plan unparsable: {path.name}: "
                            f"{e}") from e


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def export_artifact(engine, path, buckets=(1, 2, 4, 8), *,
                    head: bool = False, workload: str | None = None) -> dict:
    """Write one frozen-executor plan per bucket into directory ``path``.

    ``engine`` is a :class:`~repro_torch.serving.engine.PhoneBitEngine`;
    :meth:`WorkloadEngine.export_artifact` marks each bucket ``head`` (its
    loader composes and captures the postprocess head).  Each bucket is
    built (and under ``"auto"`` tuned) live first — export is the offline
    half, so paying for it here is the point.  Returns the meta block."""
    from repro_torch.obs.provenance import provenance_meta

    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = _want_env(engine)
    meta.update(input_hw=list(engine.input_hw), workload=workload,
                provenance=provenance_meta(), buckets={})
    report: dict[str, Any] = {}
    for bs in sorted({int(b) for b in buckets}):
        with _trace.span("artifact.export", "artifact", bucket=bs):
            exe = engine.compile(bs, capture=False)
            entry = {"file": f"b{bs}.plan.json", "head": bool(head)}
            plan_path = path / entry["file"]
            plan_path.write_text(json.dumps(
                dict(executor_plan(exe), bucket=bs), indent=1,
                sort_keys=True))
            entry["sha256"] = _sha256(plan_path)
            meta["buckets"][str(bs)] = entry
        report[str(bs)] = {"backends": exe.backend_report()}
    meta["report"] = report
    # The autotune winner table rides along: a loader whose environment
    # misses a bucket still warm-starts its live compile from it.
    tuner = getattr(engine, "_tuner", None)
    if tuner is not None and (tuner.cache or tuner.agnostic_cache):
        (path / _AUTOTUNE).write_text(json.dumps(
            {**tuner.cache, **tuner.agnostic_cache}, indent=1,
            sort_keys=True))
    (path / _META).write_text(json.dumps(meta, indent=1, sort_keys=True))
    return meta


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def read_meta(path) -> dict:
    path = pathlib.Path(path)
    meta_path = path / _META
    if not meta_path.exists():
        raise ArtifactError(f"not an artifact directory: {path} "
                            f"(missing {_META})")
    try:
        return json.loads(meta_path.read_text())
    except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ArtifactError(f"unreadable artifact meta: {e}") from e


def compat_mismatches(meta: dict, engine) -> list[str]:
    """Which :data:`COMPAT_FIELDS` differ between the artifact and this
    process/engine (empty list = fully compatible)."""
    want = _want_env(engine)
    return [f"{k}: artifact={meta.get(k)!r} != here={want[k]!r}"
            for k in COMPAT_FIELDS if meta.get(k) != want[k]]


def _miss(bucket: int, reasons: list[str]) -> None:
    reg = _obs_metrics.get_registry()
    reg.counter("artifact.miss").inc()
    reg.event("artifact", outcome="miss", bucket=bucket,
              reasons=list(reasons))
    _trace.instant("artifact.miss", "artifact", bucket=bucket)


def _hit(bucket: int) -> None:
    reg = _obs_metrics.get_registry()
    reg.counter("artifact.hit").inc()
    reg.event("artifact", outcome="hit", bucket=bucket)


def load_autotune_table(path, tuner) -> int:
    """Merge the artifact's winner table into a tuner's caches (entries
    already present win; entries stamped by another toolchain or card are
    skipped, as the disk cache's are).  Returns how many were adopted."""
    from repro_torch.runtime.autotune import entry_env_ok

    path = pathlib.Path(path) / _AUTOTUNE
    if not path.exists():
        return 0
    try:
        table = json.loads(path.read_text())
    except (OSError, UnicodeDecodeError, json.JSONDecodeError):
        return 0
    adopted = 0
    for key, entry in table.items():
        if not entry_env_ok(entry, tuner.device):
            continue
        store = (tuner.agnostic_cache if key.startswith("batchless::")
                 else tuner.cache)
        if key not in store:
            store[key] = entry
            adopted += 1
    return adopted


def load_artifact(engine, path, *, buckets=None, head: bool = False,
                  capture: bool | None = None) -> dict:
    """Restore bucket executors from ``path`` into ``engine``'s per-bucket
    cache, and capture each as ``engine.compile(capture=)`` does (None:
    on the card).

    Per bucket: environment mismatch -> ``artifact.miss`` event and the
    live compile path on first use; integrity failure ->
    :class:`ArtifactError`.  With ``head=True`` (a
    :class:`~repro_torch.workloads.workload.WorkloadEngine`) a bucket
    exported without the postprocess head misses.  Returns ``{"loaded":
    [buckets], "missed": {bucket: [reasons]}, "autotune_entries": n,
    "workload": name}``."""
    path = pathlib.Path(path)
    meta = read_meta(path)
    mismatches = compat_mismatches(meta, engine)
    tuner = getattr(engine, "_tuner", None)
    adopted = load_autotune_table(path, tuner) if tuner is not None else 0
    want = {int(b) for b in buckets} if buckets is not None else None
    loaded: list[int] = []
    missed: dict[int, list[str]] = {}
    for bs_key, entry in sorted(meta.get("buckets", {}).items(),
                                key=lambda kv: int(kv[0])):
        bs = int(bs_key)
        if want is not None and bs not in want:
            continue
        reasons = list(mismatches)
        if head and not entry.get("head"):
            reasons.append("head: artifact has no postprocess head")
        if reasons:
            missed[bs] = reasons
            _miss(bs, reasons)
            continue
        with _trace.span("artifact.load", "artifact", bucket=bs):
            if "file" not in entry or "sha256" not in entry:
                raise ArtifactError(f"artifact meta bucket {bs} has no "
                                    f"plan entry")
            plan = _read_plan(path / entry["file"], entry["sha256"])
            exe = executor_from_plan(engine._graph, plan,
                                     engine._plan_shape(bs),
                                     name=entry["file"])
            engine._install_executable(bs, exe)
            engine.compile(bs, capture=capture)   # captured here, on a card
        loaded.append(bs)
        _hit(bs)
    return {"loaded": loaded, "missed": missed,
            "autotune_entries": adopted, "workload": meta.get("workload")}
