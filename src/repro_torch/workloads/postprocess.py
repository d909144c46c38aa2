"""Postprocess heads: top-k classification and YOLOv2 decode + NMS.

Counterpart of ``repro.workloads.postprocess``.  Both heads are batched
tensor functions with fixed-size outputs, and queue on the device without
a host round trip, so they run right after the forward inside a serving
bucket.  Row formats:

* classification — ``(k, 2)`` rows ``[class_index, probability]``,
  probability-descending;
* detection      — ``(max_det, 6)`` rows ``[x1, y1, x2, y2, score,
  class_index]`` in network-input pixels, score-descending; rows past the
  surviving detections are all-zero (``score > 0`` is the validity mask).

Ties: ``lax.top_k`` returns the lower index first; ``torch.topk`` on CUDA
makes no promise about the order of equal values.  Random logits have no
ties; exact ties (e.g. saturated softmax) may order differently.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# YOLOv2-Tiny VOC anchor priors, in grid-cell units (darknet cfg).
YOLOV2_TINY_VOC_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                           (9.42, 5.11), (16.62, 10.52))

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")

# Score assigned to candidates below score_thresh.
_NEG = -1e9


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Static decode/NMS parameters."""
    anchors: tuple[tuple[float, float], ...] = YOLOV2_TINY_VOC_ANCHORS
    n_classes: int = 20
    score_thresh: float = 0.3
    iou_thresh: float = 0.45
    max_det: int = 16
    class_names: tuple[str, ...] | None = VOC_CLASSES

    @property
    def channels(self) -> int:
        return len(self.anchors) * (5 + self.n_classes)


def topk_head(logits: torch.Tensor, k: int) -> torch.Tensor:
    """(N, n_classes) logits -> (N, k, 2) rows [class_index, probability]."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, min(k, logits.shape[-1]), dim=-1)
    return torch.stack([idx.to(torch.float32), vals], dim=-1)


@functools.lru_cache(maxsize=None)
def _anchors(anchors: tuple[tuple[float, float], ...],
             device: torch.device) -> torch.Tensor:
    """The anchor priors on ``device``, made once: a tensor made from host
    values is a host-to-device copy, which a captured head cannot hold."""
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def decode_yolo(feat: torch.Tensor, cfg: DetectConfig,
                input_hw: tuple[int, int]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, Hg, Wg, A*(5+C)) raw map -> (boxes (N, M, 4) x1y1x2y2 in
    network pixels, scores (N, M), classes (N, M) int32), M = Hg*Wg*A."""
    n, hg, wg, ch = feat.shape
    a = len(cfg.anchors)
    if ch != cfg.channels:
        raise ValueError(f"feature map has {ch} channels, want "
                         f"{cfg.channels}")
    f = feat.reshape(n, hg, wg, a, 5 + cfg.n_classes)
    dev = feat.device
    xy = torch.sigmoid(f[..., 0:2])
    cx = torch.arange(wg, dtype=torch.float32, device=dev)[None, None, :, None]
    cy = torch.arange(hg, dtype=torch.float32, device=dev)[None, :, None, None]
    bx = (xy[..., 0] + cx) / wg
    by = (xy[..., 1] + cy) / hg
    anchors = _anchors(cfg.anchors, dev)
    bw = anchors[:, 0] * torch.exp(f[..., 2]) / wg
    bh = anchors[:, 1] * torch.exp(f[..., 3]) / hg

    conf = torch.sigmoid(f[..., 4])
    probs = torch.softmax(f[..., 5:], dim=-1)
    best, cls_idx = torch.max(probs, dim=-1)
    scores = conf * best

    ih, iw = input_hw
    x1 = torch.clamp((bx - bw / 2) * iw, 0, iw)
    y1 = torch.clamp((by - bh / 2) * ih, 0, ih)
    x2 = torch.clamp((bx + bw / 2) * iw, 0, iw)
    y2 = torch.clamp((by + bh / 2) * ih, 0, ih)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    m = hg * wg * a
    return (boxes.reshape(n, m, 4), scores.reshape(n, m),
            cls_idx.to(torch.int32).reshape(n, m))


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., M, 4) x (..., K, 4) x1y1x2y2 boxes ->
    (..., M, K)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = torch.prod(torch.clamp(rb - lt, min=0), dim=-1)
    area_a = torch.prod(torch.clamp(a[..., 2:] - a[..., :2], min=0), dim=-1)
    area_b = torch.prod(torch.clamp(b[..., 2:] - b[..., :2], min=0), dim=-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))


def _nms_batched(boxes, scores, classes, *, iou_thresh: float,
                 score_thresh: float, max_det: int) -> torch.Tensor:
    """Greedy class-aware NMS over (N, M, 4) boxes -> (N, max_det, 6)."""
    n, m, _ = boxes.shape
    k = min(max_det, m)
    # score > 0 is the row-validity convention.
    s = torch.where((scores >= score_thresh) & (scores > 0), scores,
                    torch.full_like(scores, _NEG))
    top_s, idx = torch.topk(s, k, dim=-1)
    cand = torch.gather(boxes, 1, idx[..., None].expand(n, k, 4))
    cand_cls = torch.gather(classes, 1, idx)

    # Class-aware: translate each class into its own disjoint region so
    # cross-class IoU is exactly 0 in one shared matrix.
    span = boxes.abs().amax(dim=(1, 2)) + 1.0                       # (N,)
    shifted = cand + (cand_cls.to(boxes.dtype) * 4.0
                      * span[:, None])[..., None]
    ious = iou_matrix(shifted, shifted)                             # (N,k,k)
    valid = top_s > _NEG / 2

    # The classic sequential algorithm, one candidate per step (k <=
    # max_det steps), all on the device.
    keep = torch.zeros((n, k), dtype=torch.bool, device=boxes.device)
    not_self = ~torch.eye(k, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        overlapped = keep & (ious[:, i] > iou_thresh) & not_self[i]
        keep[:, i] = valid[:, i] & ~overlapped.any(dim=-1)

    rows = torch.cat([cand, top_s[..., None],
                      cand_cls.to(torch.float32)[..., None]], dim=-1)
    rows = torch.where(keep[..., None], rows, torch.zeros_like(rows))
    # Compact: surviving rows first (already score-descending; the sort on
    # the drop mask is stable), zeros after.
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    rows = torch.gather(rows, 1, order[..., None].expand(n, k, 6))
    if k < max_det:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, max_det - k))
    return rows


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              classes: torch.Tensor | None = None, *,
              iou_thresh: float = 0.45, score_thresh: float = 0.0,
              max_det: int = 16) -> torch.Tensor:
    """Greedy NMS over one image's (M, 4) boxes -> (max_det, 6) rows
    ``[x1, y1, x2, y2, score, class]``, score-descending, zero-padded;
    class-aware when ``classes`` is given."""
    if classes is None:
        classes = torch.zeros(scores.shape, dtype=torch.int32,
                              device=scores.device)
    return _nms_batched(boxes[None], scores[None], classes[None],
                        iou_thresh=iou_thresh, score_thresh=score_thresh,
                        max_det=max_det)[0]


def detect_head(feat: torch.Tensor, cfg: DetectConfig,
                input_hw: tuple[int, int]) -> torch.Tensor:
    """Raw YOLO map -> (N, max_det, 6) decoded detections."""
    boxes, scores, classes = decode_yolo(feat, cfg, input_hw)
    return _nms_batched(boxes, scores, classes, iou_thresh=cfg.iou_thresh,
                        score_thresh=cfg.score_thresh, max_det=cfg.max_det)


def detections_to_dicts(rows, cfg: DetectConfig) -> list[dict]:
    """One image's (max_det, 6) rows -> readable dicts (valid rows only)."""
    out = []
    for x1, y1, x2, y2, score, cls in np.asarray(rows):
        if score <= 0:
            continue
        cls = int(cls)
        name = (cfg.class_names[cls] if cfg.class_names else str(cls))
        out.append(dict(box=[float(x1), float(y1), float(x2), float(y2)],
                        score=float(score), class_id=cls, label=name))
    return out
