"""The Workload abstraction: preprocess + model + postprocess as one object.

Counterpart of ``repro.workloads.workload``.  A :class:`Workload` bundles
everything between an arbitrary-size uint8 image and a prediction row:

* the task's preprocessing (letterbox for detection, center-crop for
  classification), exposed as an ``InferenceServer`` ``preprocess=`` hook;
* the paper network (spec + a numpy-seeded checkpoint, or latent params
  handed in as numpy arrays), served through
  :class:`~repro_torch.serving.engine.PhoneBitEngine` on the workload's
  device;
* the postprocess head (top-k / YOLO decode + fixed-size NMS), composed
  onto the engine's per-bucket executors by :class:`WorkloadEngine` — on
  the card captured in the same CUDA graph as the forward, one graph a
  bucket — so the server scatters decoded rows.

    wl = workloads.get("alexnet_imagenet")            # on the card
    server = wl.server(max_batch=8)
    server.submit(any_uint8_image); server.drain()

Each paper entry also has a ``variant="tiny"`` — the reference's
topology-preserving scaled-down net, used by the parity tests.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bnn_model
from repro_torch.core.bnn_model import (BConv, BDense, FloatConv,
                                        FloatDense, Pool)
from repro_torch.models import paper_nets
from repro_torch.runtime.executor import CapturedExecutor
from repro_torch.serving.engine import PhoneBitEngine
from repro_torch.serving.server import InferenceServer
from repro_torch.workloads import postprocess as post
from repro_torch.workloads import preprocess as pre
from repro_torch.workloads.postprocess import DetectConfig


def checkpoint_params(spec, seed: int = 0) -> list[dict]:
    """Deterministic latent-float params from ``seed``: the numpy-seeded
    :func:`~repro_torch.core.bnn_model.init_params`, then randomized BN
    statistics (identity BN would make half the integer thresholds
    degenerate), drawn as the reference draws them.  The weights are not
    the reference's ``jax.random`` bits."""
    params = bnn_model.init_params(np.random.default_rng(seed), spec)
    rng = np.random.default_rng(seed)
    for p in params:
        if "mu" in p:
            o = p["mu"].shape[0]
            for k, lo, hi in (("mu", -20, 20), ("var", 0.5, 4),
                              ("gamma", -1.5, 1.5), ("beta", -1, 1)):
                p[k] = torch.as_tensor(rng.uniform(lo, hi, o),
                                       dtype=torch.float32)
    return params


class WorkloadEngine:
    """A PhoneBitEngine with the workload's postprocess head composed onto
    its per-bucket executors (the engine surface ``InferenceServer``
    consumes: ``compile`` / ``_plan_shape`` / ``device`` / ``matmul_mode``
    / ``build_count``, and the artifact loader's ``_graph`` / ``_tuner`` /
    ``_install_executable``).

    On the card a bucket is one CUDA graph of the frozen forward and the
    head (the reference exports the head per bucket beside the forward);
    the graph keeps the forward's raw output too, which :meth:`cross_check`
    holds against the flat oracle."""

    def __init__(self, engine: PhoneBitEngine,
                 head: Callable[[torch.Tensor], torch.Tensor]):
        self.engine = engine
        self.head = head

    def compile(self, batch_size: int | None = None, *,
                mode: str | None = None, capture: bool | None = None,
                **placement):
        """The wrapped engine's bucket with the head composed on;
        ``placement`` is its ``pipeline=`` or ``data_parallel=`` (the head
        rides the last stage's graph, or each shard's)."""
        return self.engine.compile(batch_size, mode=mode, capture=capture,
                                   head=self.head, **placement)

    def view(self) -> "WorkloadEngine":
        """The same head over a view of the engine (a replica's)."""
        return WorkloadEngine(self.engine.view(), self.head)

    def _plan_shape(self, batch: int | None = None):
        return self.engine._plan_shape(batch)

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def matmul_mode(self) -> str:
        return self.engine.matmul_mode

    @property
    def capture_count(self) -> int:
        return self.engine.capture_count

    @property
    def build_count(self) -> int:
        return self.engine.build_count

    # ---- executable artifacts (DESIGN.md §12) -----------------------------
    @property
    def _graph(self):
        return self.engine._graph

    @property
    def _tuner(self):
        return self.engine._tuner

    def _install_executable(self, batch_size: int, exe, **kw) -> None:
        """The frozen forward goes to the wrapped engine; the head is
        composed (and captured) by :meth:`compile`."""
        self.engine._install_executable(batch_size, exe, **kw)

    def export_artifact(self, path, buckets=(1, 2, 4, 8), *,
                        workload: str | None = None) -> dict:
        """Export the buckets' frozen forwards marked as carrying the
        postprocess head, so a loaded workload serves decoded rows."""
        from repro_torch.serving import artifact as _artifact

        return _artifact.export_artifact(
            self.engine, path, buckets, head=True, workload=workload)

    def load_artifact(self, path, *, buckets=None,
                      capture: bool | None = None) -> dict:
        """Restore the forwards into the wrapped engine and capture each
        with the head (one graph a bucket on the card)."""
        from repro_torch.serving import artifact as _artifact

        return _artifact.load_artifact(self, path, buckets=buckets,
                                       head=True, capture=capture)

    # ---- direct calls -------------------------------------------------------
    def __call__(self, x_uint8) -> torch.Tensor:
        x = self.engine._input(x_uint8)
        return self.compile(x.shape[0])(x)

    def raw(self, x_uint8) -> torch.Tensor:
        """Pre-head network output (logits / feature map)."""
        return self.engine(x_uint8)

    def cross_check(self, x_uint8) -> torch.Tensor:
        """The bucket's raw output (on the card: the same graph that
        serves) asserted equal to the flat oracle bit for bit; returns the
        head applied eagerly to the oracle's output."""
        x = self.engine._input(x_uint8)
        exe = self.compile(x.shape[0])
        if isinstance(exe, CapturedExecutor):
            raw = exe.run(x)[1]
        else:
            raw = self.engine.compile(x.shape[0], capture=False)(x)
        ref = self.engine.legacy_call(x)
        if not torch.equal(raw, ref):
            raise AssertionError(
                f"graph path ({self.matmul_mode}) diverges from the flat "
                f"oracle: max |diff| {(raw - ref).abs().max().item()}")
        return self.head(ref)


@dataclasses.dataclass
class Workload:
    """One deployable paper workload: preprocess -> engine -> postprocess."""

    name: str
    task: str                                  # "classify" | "detect"
    spec: list
    input_hw: tuple[int, int]
    params: list                               # latent floats, numpy or torch
    matmul_mode: str = "cuda_direct_pool"
    top_k: int = 5
    detect: DetectConfig | None = None
    class_names: tuple[str, ...] | None = None
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.task not in ("classify", "detect"):
            raise ValueError(f"unknown task {self.task!r}")
        if self.task == "detect" and self.detect is None:
            self.detect = DetectConfig()

    def preprocess(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W, C) uint8 at any size -> network-size uint8."""
        if self.task == "detect":
            return pre.letterbox(img, self.input_hw)
        return pre.center_crop_resize(img, self.input_hw)

    @functools.cached_property
    def preprocess_hook(self) -> Callable[[np.ndarray], torch.Tensor]:
        """Per-payload hook for ``InferenceServer``: numpy in, uint8
        tensor out, computed on the workload's device."""
        return pre.as_server_hook(self.preprocess, self.device)

    def postprocess(self, raw: torch.Tensor) -> torch.Tensor:
        """Network output -> fixed-size prediction rows."""
        if self.task == "detect":
            return post.detect_head(raw, self.detect, self.input_hw)
        return post.topk_head(raw, self.top_k)

    @functools.cached_property
    def engine(self) -> WorkloadEngine:
        base = PhoneBitEngine.from_trained(self.params, self.spec,
                                           self.input_hw,
                                           matmul_mode=self.matmul_mode,
                                           device=self.device)
        return WorkloadEngine(base, self.postprocess)

    def server(self, **kw) -> InferenceServer:
        kw.setdefault("preprocess", self.preprocess_hook)
        return InferenceServer(self.engine, **kw)

    def predict(self, images) -> np.ndarray:
        """End-to-end convenience: raw uint8 HWC images (any sizes) ->
        stacked prediction rows."""
        x = torch.stack([self.preprocess_hook(np.asarray(i))
                         for i in images])
        return self.engine(x).cpu().numpy()

    def format(self, row) -> list[dict]:
        """One request's prediction rows -> readable dicts."""
        if self.task == "detect":
            return post.detections_to_dicts(row, self.detect)
        return [dict(class_id=int(c), prob=float(p),
                     label=(self.class_names[int(c)]
                            if self.class_names else str(int(c))))
                for c, p in np.asarray(row)]

    @property
    def model_bytes(self) -> int:
        return self.engine.engine.model_bytes


# --------------------------------------------------------------------------
# Tiny (topology-preserving) conformance variants — the reference's shapes
# --------------------------------------------------------------------------

def _tiny_alexnet():
    spec = [
        BConv(3, 32, kernel=5, stride=2, pad=2, first=True),
        Pool(2, 2),
        BConv(32, 48, kernel=3, stride=1, pad=1),
        Pool(2, 2),
        BDense(2 * 2 * 48, 64),
        BDense(64, 64),
        FloatDense(64, 10),
    ]
    return spec, (16, 16)


def _tiny_vgg16():
    spec = [
        BConv(3, 16, kernel=3, stride=1, pad=1, first=True),
        BConv(16, 16, kernel=3, stride=1, pad=1),
        Pool(2, 2),
        BConv(16, 32, kernel=3, stride=1, pad=1),
        BConv(32, 32, kernel=3, stride=1, pad=1),
        Pool(2, 2),
        BDense(4 * 4 * 32, 64),
        BDense(64, 64),
        FloatDense(64, 10),
    ]
    return spec, (16, 16)


def _tiny_yolov2(detect: DetectConfig):
    spec = [
        BConv(3, 16, kernel=3, stride=1, pad=1, first=True),
        Pool(2, 2),
        BConv(16, 32, kernel=3, stride=1, pad=1),
        Pool(2, 2),
        BConv(32, 64, kernel=3, stride=1, pad=1),
        Pool(2, 1, pad=(0, 1)),
        BConv(64, 64, kernel=3, stride=1, pad=1),
        FloatConv(64, detect.channels, kernel=1, stride=1, pad=0),
    ]
    return spec, (32, 32)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Workload]] = {}


def register(name: str, builder: Callable[..., Workload]) -> None:
    _REGISTRY[name] = builder


def names() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str, **kw) -> Workload:
    """Build a registered workload.  Common kwargs: ``variant`` ("paper"
    default, or "tiny"), ``matmul_mode`` (a port backend or
    ``cuda_chain``), ``input_hw`` (int or (h, w); fully-conv nets only),
    ``seed``, ``params`` (latent params to serve instead of the seeded
    checkpoint), ``device`` ("cuda" default)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown workload {name!r}; have {names()}")
    return _REGISTRY[name](**kw)


def _hw(input_hw) -> tuple[int, int] | None:
    if input_hw is None:
        return None
    if isinstance(input_hw, int):
        return (input_hw, input_hw)
    return tuple(input_hw)


def _classify_builder(net: str, tiny_fn):
    def build(*, variant: str = "paper", matmul_mode: str = "cuda_direct_pool",
              seed: int = 0, top_k: int = 5, input_hw=None, params=None,
              device="cuda") -> Workload:
        if variant == "paper":
            spec, (h, w, _) = paper_nets.get(net)
        elif variant == "tiny":
            spec, (h, w) = tiny_fn()
        else:
            raise ValueError(f"unknown variant {variant!r}")
        if _hw(input_hw) not in (None, (h, w)):
            raise ValueError(
                f"{net} has dense layers fixed to {(h, w)} inputs")
        return Workload(
            name=f"{net}_imagenet" if variant == "paper" else
                 f"{net}_imagenet[tiny]",
            task="classify", spec=spec, input_hw=(h, w),
            params=params if params is not None
            else checkpoint_params(spec, seed),
            matmul_mode=matmul_mode, top_k=top_k, seed=seed, device=device)
    return build


def _detect_builder(name: str, net: str, tiny_fn):
    def build(*, variant: str = "paper", matmul_mode: str = "cuda_direct_pool",
              seed: int = 0, input_hw=None, params=None,
              detect: DetectConfig | None = None, device="cuda") -> Workload:
        detect = detect if detect is not None else DetectConfig()
        if variant == "paper":
            spec, (h, w, _) = paper_nets.get(net)
        elif variant == "tiny":
            spec, (h, w) = tiny_fn(detect)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        # Fully convolutional: any resolution the pool ladder divides.
        h, w = _hw(input_hw) or (h, w)
        return Workload(
            name=name if variant == "paper" else f"{name}[tiny]",
            task="detect", spec=spec, input_hw=(h, w),
            params=params if params is not None
            else checkpoint_params(spec, seed),
            matmul_mode=matmul_mode, detect=detect,
            class_names=detect.class_names, seed=seed, device=device)
    return build


register("alexnet_imagenet", _classify_builder("alexnet", _tiny_alexnet))
register("vgg16_imagenet", _classify_builder("vgg16", _tiny_vgg16))
register("yolov2_tiny_voc",
         _detect_builder("yolov2_tiny_voc", "yolov2-tiny", _tiny_yolov2))
