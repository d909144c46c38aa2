"""Assigned input-shape sets, one table per architecture family.

The same tables as ``repro.configs.shapes`` (a copy: the port imports
nothing of the reference).  Each (arch × shape) pair is a *cell*;
``kind`` says which step it runs:

  train    train_step  (fwd + bwd + optimizer)
  prefill  prefill_step (prompt forward + KV-cache build)
  decode   decode_step (one token against a seq_len KV cache)
  sample   sample_step (one denoising forward; × steps for a full image)
  serve    inference forward
  skip     cell is skipped (reason recorded) — long_500k on the pure
           full-attention LM archs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # vision/diffusion fields
    img_res: int = 0
    batch: int = 0
    steps: int = 0
    note: str = ""


LM_SHAPES = (
    Shape("train_4k", "train", seq_len=4_096, global_batch=256),
    Shape("prefill_32k", "prefill", seq_len=32_768, global_batch=32),
    Shape("decode_32k", "decode", seq_len=32_768, global_batch=128),
    Shape("long_500k", "skip", seq_len=524_288, global_batch=1,
          note="pure full-attention arch: 512k full attention is "
               "out of budget by construction (DESIGN.md "
               "§Arch-applicability); sub-quadratic override not a "
               "published config"),
)

DIFFUSION_SHAPES = (
    Shape("train_256", "train", img_res=256, batch=256, steps=1_000),
    Shape("gen_1024", "sample", img_res=1_024, batch=4, steps=50),
    Shape("gen_fast", "sample", img_res=512, batch=16, steps=4),
    Shape("train_1024", "train", img_res=1_024, batch=32, steps=1_000),
)

VISION_SHAPES = (
    Shape("cls_224", "train", img_res=224, batch=256),
    Shape("cls_384", "train", img_res=384, batch=64),
    Shape("serve_b1", "serve", img_res=224, batch=1),
    Shape("serve_b128", "serve", img_res=224, batch=128),
)

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
    "diffusion": DIFFUSION_SHAPES,
    "vision": VISION_SHAPES,
}
