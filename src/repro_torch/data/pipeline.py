"""Synthetic-but-realistic data pipelines (tokens / images / latents).

Counterpart of ``repro.data.pipeline``:

* **step-indexed determinism** — batch ``i`` is drawn from
  ``np.random.default_rng((seed, i))`` exactly as the reference draws it,
  so the two packages give the same batches bit for bit and a job
  restarted from step ``i`` regenerates the identical stream with no
  loader state in the checkpoint;
* **placement** — with ``device`` set, each array becomes a tensor on that
  device (the reference's ``sharding``); without it the batch stays numpy.
  ``TokenPipeline(rules=)`` draws the same batch and moves only this
  rank's rows (``rules.batch_cut``: the reference's ``batch_spec``, which
  cuts the rows over fewer batch axes, or none, where the batch does not
  divide) to its device (default: the rank's);
* **prefetch** — a background thread keeps ``prefetch`` batches ahead;
  closing the iterator stops and joins it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class _Base:
    seed: int = 0
    prefetch: int = 2

    def batch_at(self, step: int) -> Any:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self.iter_from(0)

    def iter_from(self, step: int) -> Iterator[Any]:
        """Resume-safe iterator: yields batch(step), batch(step+1), ..."""
        if self.prefetch <= 0:
            i = step
            while True:
                yield self.batch_at(i)
                i += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            i = step
            batch = None
            while not stop.is_set():
                if batch is None:
                    batch = self.batch_at(i)
                try:
                    q.put(batch, timeout=0.5)
                except queue.Full:
                    continue
                batch = None
                i += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            # Joined, not left running: a thread still drawing a batch
            # when its process exits can abort the process.
            stop.set()
            t.join()


def _place(arrays: dict, device) -> dict:
    """The batch as tensors on ``device``, or as numpy when it is None."""
    if device is None:
        return arrays
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@dataclasses.dataclass
class TokenPipeline(_Base):
    """LM batches: {tokens, labels} (B, S) int32, labels = next-token.
    With ``rules`` (a mesh's ``Rules``) each batch is this rank's rows of
    that batch, as a sharded train step takes them: any B, cut over the
    batch axes ``rules.batch_spec(B)`` keeps and whole on the ranks of the
    ones it leaves out (``make_train_step(..., batch_size=B)``)."""
    batch: int = 8
    seq_len: int = 128
    vocab: int = 256
    device: Any = None
    rules: Any = None

    def __post_init__(self):
        self._cut = None
        if self.rules is not None:
            self._cut = self.rules.batch_cut(self.batch)
            if self.device is None:
                self.device = self.rules.device

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab,
                            (self.batch, self.seq_len + 1), dtype=np.int32)
        if self._cut is not None:
            toks = self._cut.take(toks)
        out = {"tokens": np.ascontiguousarray(toks[:, :-1]),
               "labels": np.ascontiguousarray(toks[:, 1:])}
        return _place(out, self.device)


@dataclasses.dataclass
class ImagePipeline(_Base):
    """Vision batches: {images (B, R, R, 3) f32 in [0, 1], labels (B,)}."""
    batch: int = 8
    img_res: int = 32
    n_classes: int = 10
    device: Any = None

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        imgs = rng.random((self.batch, self.img_res, self.img_res, 3),
                          dtype=np.float32)
        labels = rng.integers(0, self.n_classes, (self.batch,),
                              dtype=np.int32)
        out = {"images": imgs, "labels": labels}
        return _place(out, self.device)


@dataclasses.dataclass
class LatentPipeline(_Base):
    """DiT batches: {latents, labels, t, noise} for ε-prediction."""
    batch: int = 8
    latent_res: int = 8
    channels: int = 4
    n_classes: int = 10
    n_timesteps: int = 1000
    device: Any = None

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        shape = (self.batch, self.latent_res, self.latent_res,
                 self.channels)
        out = {
            "latents": rng.standard_normal(shape, dtype=np.float32),
            "labels": rng.integers(0, self.n_classes, (self.batch,),
                                   dtype=np.int32),
            "t": rng.integers(0, self.n_timesteps, (self.batch,),
                              dtype=np.int32),
            "noise": rng.standard_normal(shape, dtype=np.float32),
        }
        return _place(out, self.device)
