"""Image preprocessing for the paper workloads (DESIGN.md §8.1).

Counterpart of ``repro.workloads.preprocess``.  The engine consumes raw
uint8 HWC pixels, so every transform maps an arbitrary-size uint8 image to
a network-size uint8 image:

* :func:`letterbox`          — aspect-preserving resize onto a gray canvas
                               (detection, the YOLO convention);
* :func:`center_crop_resize` — shorter-side resize + center crop
                               (classification, the AlexNet/VGG eval
                               convention).

Resizing is bilinear with antialiasing when downsampling
(``F.interpolate(mode="bilinear", antialias=True)``), as
``jax.image.resize(..., "bilinear")`` does; the two agree to float
rounding before the final round-to-uint8.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

# Gray letterbox fill: the YOLO convention (114 in most implementations).
LETTERBOX_FILL = 114


def letterbox_params(in_hw: tuple[int, int], out_hw: tuple[int, int]
                     ) -> tuple[float, tuple[int, int], tuple[int, int]]:
    """The static geometry of a letterbox: (scale, (top, left), (nh, nw))."""
    h, w = in_hw
    oh, ow = out_hw
    scale = min(oh / h, ow / w)
    nh, nw = min(int(round(h * scale)), oh), min(int(round(w * scale)), ow)
    top, left = (oh - nh) // 2, (ow - nw) // 2
    return scale, (top, left), (nh, nw)


def letterbox_boxes(boxes: np.ndarray, in_hw: tuple[int, int],
                    out_hw: tuple[int, int]) -> np.ndarray:
    """Map (..., 4) x1y1x2y2 boxes from original-image pixels to
    letterboxed network pixels."""
    scale, (top, left), _ = letterbox_params(in_hw, out_hw)
    boxes = np.asarray(boxes, np.float32)
    return boxes * scale + np.array([left, top, left, top], np.float32)


def unletterbox_boxes(boxes: np.ndarray, in_hw: tuple[int, int],
                      out_hw: tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`letterbox_boxes`: network-frame boxes back to
    original-image pixels, clipped to the image bounds."""
    scale, (top, left), _ = letterbox_params(in_hw, out_hw)
    boxes = np.asarray(boxes, np.float32)
    out = (boxes - np.array([left, top, left, top], np.float32)) / scale
    h, w = in_hw
    return np.clip(out, 0, np.array([w, h, w, h], np.float32))


def resize_bilinear(img: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(H, W, C) -> (nh, nw, C) float32, antialiased bilinear."""
    x = torch.as_tensor(img).to(torch.float32).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def letterbox_float(img: torch.Tensor, out_hw: tuple[int, int],
                    fill: int = LETTERBOX_FILL) -> torch.Tensor:
    """:func:`letterbox` before the final rounding (float32)."""
    h, w, c = img.shape
    oh, ow = out_hw
    _, (top, left), (nh, nw) = letterbox_params((h, w), out_hw)
    resized = resize_bilinear(img, (nh, nw))
    canvas = torch.full((oh, ow, c), float(fill), dtype=torch.float32,
                        device=resized.device)
    canvas[top:top + nh, left:left + nw] = resized
    return canvas


def letterbox(img: torch.Tensor, out_hw: tuple[int, int],
              fill: int = LETTERBOX_FILL) -> torch.Tensor:
    """Aspect-preserving resize of an (H, W, C) uint8 image onto a
    ``fill``-gray (out_h, out_w, C) canvas, content centered."""
    return _to_uint8(letterbox_float(img, out_hw, fill))


def center_crop_float(img: torch.Tensor,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    """:func:`center_crop_resize` before the final rounding (float32)."""
    h, w, c = img.shape
    oh, ow = out_hw
    short = -(-max(oh, ow) * 8 // 7)          # ceil; 256 when out is 224
    scale = short / min(h, w)
    nh = max(int(round(h * scale)), oh)
    nw = max(int(round(w * scale)), ow)
    resized = resize_bilinear(img, (nh, nw))
    top, left = (nh - oh) // 2, (nw - ow) // 2
    return resized[top:top + oh, left:left + ow]


def center_crop_resize(img: torch.Tensor,
                       out_hw: tuple[int, int]) -> torch.Tensor:
    """Shorter-side resize to ``ceil(max(out_hw) * 8 / 7)`` then center
    crop to (out_h, out_w), uint8 in/out."""
    return _to_uint8(center_crop_float(img, out_hw))


def as_server_hook(transform: Callable[[torch.Tensor], torch.Tensor],
                   device: str | torch.device = "cuda"
                   ) -> Callable[[np.ndarray], torch.Tensor]:
    """Adapt a tensor image transform to ``InferenceServer(preprocess=...)``:
    numpy payload in, network-size uint8 tensor out, computed on
    ``device`` (the engine's; the card unless the caller passes "cpu"),
    as the reference's jitted hook runs on its default device.  On the
    card the payload is staged through pinned memory, so the hook queues
    its copy and resize and returns without waiting on the device."""
    device = resolve_device(device)

    def hook(payload: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(payload))
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        return transform(x).contiguous()

    return hook
