"""PhoneBitEngine: the paper's stand-alone BNN inference engine (Fig 2/3).

Counterpart of ``repro.serving.engine``.  A trained model (latent float
params) is converted offline — BN folded to integer thresholds, weights
bit-packed, first layer bit-plane-expanded — and the engine serves the
packed integer forward through the graph runtime: the artifact is lowered
(:func:`~repro_torch.runtime.graph.lower_packed`), conv+pool pairs fuse
(:func:`~repro_torch.runtime.passes.fuse_pool_epilogue`), and a
:class:`~repro_torch.runtime.executor.GraphExecutor` runs it on the
engine's device.  The flat :func:`~repro_torch.core.bnn_model.packed_forward`
walk stays as the ``legacy_call`` / ``cross_check`` oracle.

``matmul_mode`` is a port backend (``torch``, ``torch_pm1``, ``cuda_pm1``,
``cuda_popcount``, ``cuda_direct``, ``cuda_direct_pool``; default
``cuda_direct_pool``), the region mode ``cuda_chain`` — chains of packed
convs and pools run as one K5 launch each
(:mod:`repro_torch.runtime.regions`), the rest per node along the
fallback order; on the card each chain's tile is autotuned — or
``"auto"``: each node's backend, and K3's tile, chosen by measurement on
the engine's device (:mod:`repro_torch.runtime.autotune`; one tuner an
engine, winners shared process-wide and persisted to disk, where
``REPRO_AUTOTUNE_CACHE=0`` opts out).  Under the pm1 modes the flat
oracle takes the +-1 matmul count form too.

Batched serving goes through the per-bucket executor cache:
``compile(batch_size)`` builds an executor once per (bucket, mode); under
``"auto"`` each bucket is tuned at its own batch shape, and winners
transfer across buckets.  On the card the frozen executor is then
captured as one CUDA graph (:class:`~repro_torch.runtime.executor.
CapturedExecutor`, the counterpart of the reference's compiled bucket
executable; ``capture=False`` keeps the eager executor, for debugging);
the tuner times its candidates eagerly before that.  ``build_count`` —
executors built, graphs captured (``capture_count``) and kernel-library
loads — must stay flat while requests flow.

``export_artifact`` / ``load_artifact`` (:mod:`repro_torch.serving.
artifact`) carry each bucket's frozen executor to a fresh process, which
then captures without tuning, planning or building.

Placement (DESIGN.md §13, :mod:`repro_torch.runtime.placement`):
``compile(..., pipeline=devices)`` builds a bucket as a
:class:`~repro_torch.runtime.placement.StagedExecutor` cut over
``devices``, and ``compile(..., data_parallel=devices)`` as a
:class:`~repro_torch.runtime.placement.ShardedExecutor` of one row shard a
device (the reference's ``data_parallel`` is a shard count over a mesh;
the port's names the shards' devices).  On the card each stage or shard
is captured on its device into that device's graph pool.  The two are
exclusive on one executor.  A device may be named more than once.

    engine = PhoneBitEngine.from_artifact("model.npz", spec, (227, 227))
    logits = engine(images_uint8)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import bnn_model, converter, layer_integration
from repro_torch.device import resolve_device
from repro_torch.kernels import build as _build
from repro_torch.obs import inject as _inject
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _trace
from repro_torch.runtime import autotune as _autotune
from repro_torch.runtime import executor as _executor
from repro_torch.runtime import memory as _memory
from repro_torch.runtime import placement as _placement
from repro_torch.runtime import regions as _regions
from repro_torch.runtime.graph import lower_packed
from repro_torch.runtime.passes import fuse_pool_epilogue

# Modes whose flat-path count form is the +-1 matmul.
_PM1_MODES = ("cuda_pm1", "torch_pm1")
# Process-wide autotune caches: engines serving structurally identical
# layers share measurements; the batchless cache carries winners across
# buckets.
_AUTOTUNE_CACHE: dict = {}
_AUTOTUNE_AGNOSTIC: dict = {}


def _device_key(device: torch.device) -> torch.device:
    """``cuda`` as the indexed device it means, so one card is one key."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _to_device(v, device: torch.device):
    if isinstance(v, layer_integration.IntegratedParams):
        return layer_integration.IntegratedParams(
            *(_to_device(f, device) for f in v))
    if isinstance(v, (int, np.integer)):
        return int(v)
    t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    if t.ndim == 0 and not t.is_floating_point():
        return int(t)                       # layout metadata (c_per_pos)
    return t.to(device).contiguous()


@dataclasses.dataclass
class PhoneBitEngine:
    spec: Sequence[Any]
    packed: list[dict]
    input_hw: tuple[int, int]
    matmul_mode: str = "cuda_direct_pool"
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.packed = [{k: _to_device(v, self.device)
                        for k, v in layer.items()} for layer in self.packed]
        # Keyed (bucket, mode), extended by a placement's devices.
        self._compiled: dict[tuple, _executor.GraphExecutor] = {}
        # The executor's key and the head: a head is captured with its
        # forward.
        self._captured: dict[tuple, _executor.CapturedExecutor] = {}
        # Tuners and graph pools of placement devices other than the
        # engine's own.
        self._tuners: dict[torch.device, _autotune.Autotuner] = {}
        self._pools: dict[torch.device, Any] = {}

    def view(self) -> "PhoneBitEngine":
        """An engine over the same packed tensors (on the device already,
        so ``__post_init__`` keeps them, uncopied) with its own executor
        and capture caches and its own graph pool: a replica's engine."""
        return dataclasses.replace(self)

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_trained(cls, params, spec, input_hw, **kw) -> "PhoneBitEngine":
        """Offline conversion (Fig 2): fold + pack trained params."""
        return cls(spec=spec, packed=converter.convert(params, spec,
                                                       input_hw),
                   input_hw=input_hw, **kw)

    @classmethod
    def from_artifact(cls, path: str, spec, input_hw,
                      **kw) -> "PhoneBitEngine":
        return cls(spec=spec, packed=converter.load_artifact(path),
                   input_hw=input_hw, **kw)

    def prepare(self) -> tuple[list[dict], list[dict]]:
        """Split the packed artifact into tensors vs static metadata
        (``c_per_pos``): ``(arrays, meta)``."""
        meta = [{k: int(v) for k, v in layer.items() if k == "c_per_pos"}
                for layer in self.packed]
        arrays = [{k: v for k, v in layer.items() if k != "c_per_pos"}
                  for layer in self.packed]
        return arrays, meta

    # ---- graph runtime path (default) ------------------------------------
    @functools.cached_property
    def _graph(self):
        return fuse_pool_epilogue(
            lower_packed(self.spec, self.packed, self.input_hw))

    @functools.cached_property
    def _tuner(self) -> _autotune.Autotuner:
        """One Autotuner an engine (the disk cache is read once), over the
        process-wide caches."""
        return _autotune.Autotuner(cache=_AUTOTUNE_CACHE,
                                   agnostic_cache=_AUTOTUNE_AGNOSTIC,
                                   device=self.device)

    def compile(self, batch_size: int | None = None, *,
                mode: str | None = None, capture: bool | None = None,
                head=None, pipeline: Sequence[Any] | None = None,
                data_parallel: Sequence[Any] | None = None):
        """The cached executor for one serving bucket, built (and under
        ``"auto"`` tuned) on first request.  ``mode`` overrides
        ``matmul_mode`` for this executor.  ``capture`` (default: on for a
        CUDA device, off for the CPU) returns it captured as one CUDA
        graph (:class:`~repro_torch.runtime.executor.CapturedExecutor`);
        ``capture=False`` returns the eager :class:`GraphExecutor`.

        ``head`` (a workload's postprocess) is composed onto the forward:
        eagerly a callable ``head(forward(x))``; captured, one graph of
        both whose second output keeps the forward's raw result.

        The server's degradation ladder calls this with a demoted
        ``mode`` at a bucket's next dispatch: the rung's executor is then
        built and captured there, into the engine's one graph pool, and
        counted in ``build_count`` and ``capture_count``.  The
        ``engine.compile`` fault site fires before a new ``(bucket,
        mode)`` executor is built.

        ``pipeline`` (devices) builds the bucket as a staged executor,
        ``data_parallel`` (devices, one a shard; the bucket must split
        evenly) as a sharded one; their devices extend the cache key, so
        the key shapes never collide."""
        mode = mode or self.matmul_mode
        bs = batch_size if batch_size is not None else 1
        if bs < 1:
            raise ValueError(f"batch_size must be >= 1, got {bs}")
        if pipeline is not None and data_parallel is not None:
            raise ValueError("pipeline placement and data_parallel are "
                             "mutually exclusive on one executor; compose "
                             "replicas of pipelines instead")
        capture = self.resolve_capture(capture)
        key: tuple = (bs, mode)
        placed = pipeline if pipeline is not None else data_parallel
        if placed is not None:
            placed = tuple(_device_key(resolve_device(d)) for d in placed)
            if not placed:
                raise ValueError("a placement needs >= 1 device")
            if data_parallel is not None and bs % len(placed):
                raise ValueError(f"bucket {bs} not divisible by "
                                 f"data_parallel={len(placed)}")
            names = tuple(str(d) for d in placed)
            key = key + ((names,) if pipeline is not None
                         else ("data", names))
        if key not in self._compiled:
            # Fault site: a build that fails (the resilience layer demotes
            # a bucket through it; nothing is cached).
            if _inject._PLAN is not None:
                _inject.maybe_fault("engine.compile", bucket=bs, mode=mode)
            with _trace.span("compile.executor", "compile", bucket=bs,
                             mode=mode):
                if placed is not None:
                    cls = (_placement.StagedExecutor if pipeline is not None
                           else _placement.ShardedExecutor)
                    exe = cls(self._graph, self._plan_shape(bs), placed,
                              mode=mode, tuner=self._placed_tuner(mode))
                elif mode == "auto":
                    exe = self._tuner.tuned_executor(self._graph,
                                                     self._plan_shape(bs))
                elif mode == _executor.CHAIN_BACKEND:
                    # Regions are planned at this bucket's shape; their
                    # tiles are tuned on the card only, as the reference
                    # tunes them on its accelerator only.
                    exe = _regions.chain_executor(
                        self._graph, self._plan_shape(bs),
                        tuner=(self._tuner if self.device.type == "cuda"
                               else None))
                else:
                    exe = _executor.GraphExecutor(self._graph, mode)
            self._record_compile_metrics(
                exe, bs // len(placed) if data_parallel is not None else bs)
            self._compiled[key] = exe
        exe = self._compiled[key]
        if not capture:
            return exe if head is None else (lambda x: head(exe(x)))
        ckey = key + (head,)
        if ckey not in self._captured:
            with _trace.span("compile.capture", "compile", bucket=bs):
                if pipeline is not None:
                    cap = _placement.CapturedStages(exe, head,
                                                    self._pool_for)
                elif data_parallel is not None:
                    cap = _placement.CapturedShards(exe, head,
                                                    self._pool_for)
                else:
                    cap = _executor.CapturedExecutor(
                        _placement._with_head(exe, head),
                        self._plan_shape(bs), self.device,
                        pool=self._graph_pool, executor=exe)
                self._captured[ckey] = cap
        return self._captured[ckey]

    def _tuner_for(self, device: torch.device) -> _autotune.Autotuner:
        """The engine's tuner on its own device, else one a device over
        the same process-wide caches."""
        if device == _device_key(self.device):
            return self._tuner
        if device not in self._tuners:
            self._tuners[device] = _autotune.Autotuner(
                cache=_AUTOTUNE_CACHE, agnostic_cache=_AUTOTUNE_AGNOSTIC,
                device=device)
        return self._tuners[device]

    def _placed_tuner(self, mode: str):
        """A placed executor's tuner factory: every device under
        ``"auto"``; under ``cuda_chain`` the card's only (region tiles
        are tuned on the card, as in :meth:`compile`)."""
        if mode == "auto":
            return self._tuner_for
        if mode == _executor.CHAIN_BACKEND:
            return lambda d: self._tuner_for(d) if d.type == "cuda" else None
        return None

    def _pool_for(self, device: torch.device):
        """The graph pool of ``device``: the engine's own on its device."""
        if device == _device_key(self.device):
            return self._graph_pool
        if device not in self._pools:
            with torch.cuda.device(device):
                self._pools[device] = torch.cuda.graph_pool_handle()
        return self._pools[device]

    def resolve_capture(self, capture: bool | None) -> bool:
        """``capture=None`` is on for a CUDA device and off for the CPU; a
        graph needs the card."""
        if capture is None:
            return self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device; this "
                             f"engine is on {self.device}")
        return bool(capture)

    @functools.cached_property
    def _graph_pool(self):
        """One CUDA-graph memory pool for every bucket of this engine."""
        return torch.cuda.graph_pool_handle()

    def _record_compile_metrics(self, exe: _executor.GraphExecutor,
                                bs: int) -> None:
        """Publish a freshly built bucket's memory series to the process
        registry: the arena plan's peak and, for a region executor, the
        device traffic its chains keep on chip."""
        reg = _obs_metrics.get_registry()
        plan = _memory.plan_memory(exe.graph, self._plan_shape(bs))
        reg.gauge("runtime.arena_peak_bytes").set(plan.peak_bytes())
        if exe.regions:
            reg.gauge("runtime.chain_hbm_bytes_avoided").set(
                sum(c.hbm_bytes_avoided() for c in exe.regions))

    @property
    def capture_count(self) -> int:
        """CUDA graphs captured: one a bucket, mode and head, and one a
        stage or shard of a placed bucket."""
        return sum(c.n_graphs for c in self._captured.values())

    @property
    def build_count(self) -> int:
        """Executors built, graphs captured and kernel-library loads: the
        serve-time no-rebuild hook (it must stay flat while requests
        flow)."""
        return len(self._compiled) + self.capture_count + _build.loads()

    # ---- executable artifacts (DESIGN.md §12) -----------------------------
    def _install_executable(self, batch_size: int,
                            exe: _executor.GraphExecutor, *,
                            mode: str | None = None) -> None:
        """Register a prebuilt frozen bucket executor under the key
        :meth:`compile` uses — the artifact loader's entry point (the
        loader then captures it through :meth:`compile`)."""
        self._compiled[(int(batch_size), mode or self.matmul_mode)] = exe

    def export_artifact(self, path, buckets=(1, 2, 4, 8)) -> dict:
        """Write each bucket's frozen executor, the autotune winner table
        and a provenance meta block into the directory ``path``: the
        offline half of zero-warm-up serving.  Distinct from
        :meth:`from_artifact`, which reads the packed *weights*."""
        from repro_torch.serving import artifact as _artifact

        return _artifact.export_artifact(self, path, buckets)

    def load_artifact(self, path, *, buckets=None,
                      capture: bool | None = None) -> dict:
        """Restore the buckets of an :meth:`export_artifact` directory
        (and, as ``capture`` says, capture them) with no tuning, planning
        or building; per-bucket environment mismatches fall back to the
        live compile path, integrity failures raise
        :class:`~repro_torch.serving.artifact.ArtifactError`."""
        from repro_torch.serving import artifact as _artifact

        return _artifact.load_artifact(self, path, buckets=buckets,
                                       capture=capture)

    def _plan_shape(self, batch: int | None = None
                    ) -> tuple[int, int, int, int]:
        h, w = self.input_hw
        c = next((l.c_in for l in self.spec
                  if isinstance(l, (bnn_model.BConv, bnn_model.FloatConv))),
                 3)
        return (batch or 1, h, w, c)

    def _input(self, x_uint8) -> torch.Tensor:
        x = torch.as_tensor(x_uint8).to(self.device)
        if tuple(x.shape[1:3]) != tuple(self.input_hw):
            raise ValueError(f"input {tuple(x.shape)} does not match the "
                             f"engine's {self.input_hw}")
        return x.contiguous()

    def __call__(self, x_uint8) -> torch.Tensor:
        x = self._input(x_uint8)
        return self.compile(x.shape[0])(x)

    # ---- legacy flat path (cross-check oracle) ---------------------------
    def legacy_call(self, x_uint8) -> torch.Tensor:
        """The flat ``packed_forward`` walk (oracle), plain PyTorch, in the
        count form of the engine's mode."""
        impl = "pm1" if self.matmul_mode in _PM1_MODES else "xor"
        return bnn_model.packed_forward(self.packed, self.spec,
                                        self._input(x_uint8), impl=impl)

    def cross_check(self, x_uint8) -> torch.Tensor:
        """Run the graph path (captured on the card) and assert
        bit-exactness vs the flat path."""
        got = self(x_uint8)
        ref = self.legacy_call(x_uint8)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"graph path ({self.matmul_mode}) diverges from the flat "
                f"oracle: max |diff| {(got - ref).abs().max().item()}")
        return got

    # ---- introspection ---------------------------------------------------
    def memory_plan(self) -> _memory.MemoryPlan:
        """Static arena plan for the serving graph (DESIGN.md §4.4)."""
        return _memory.plan_memory(self._graph, self._plan_shape())

    @property
    def backend_choices(self) -> list[dict]:
        """Per-node backends and tiles (fixed by the mode or frozen by the
        autotuner) and fused regions of the batch-1 executor."""
        return self.compile(capture=False).backend_report()

    @property
    def model_bytes(self) -> int:
        return converter.model_bytes(self.packed)
