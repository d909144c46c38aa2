"""Atomic, restart-safe checkpoint store (npz tree format).

Counterpart of ``repro.checkpoint.store``.  Write protocol (crash-safe):
  1. serialize the tree to ``<dir>/tmp.<step>.<pid>.npz`` (a unique temp
     name),
  2. ``os.replace`` it to ``<dir>/step_<step>.npz`` — atomic on POSIX,
  3. apply retention (keep the last N), never deleting the file just
     written.

A checkpoint is therefore either fully present or absent; a job killed
mid-write leaves only a tmp file that the next run ignores.

Each leaf is stored as a host array under its path as
``jax.tree_util.keystr`` names it in the reference (``['params']['embed']``,
``['opt'].mu['layers']['wq']``, ``['opt'].step``), so the two packages
read each other's checkpoints.  numpy has no bf16: a bf16 leaf is stored
as float32 (exactly) and restored in the dtype of the tree it is restored
into.  ``restore(..., device=)`` places the leaves, where the reference
takes shardings.  The archive is not compressed (the reference's is;
``np.load`` reads both): float32 weights and moments shrink by some 7%
under zlib, which writes 100 MB of them in 5.5 s on one CPU core, and
lm-100m's {params, opt} hold 1.2 GB.

``CheckpointManager.save_async`` copies the tree to host memory on the
caller's thread and writes it in the background.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(t: Any) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in tree.flatten_with_paths(t)}


def save(directory: str | os.PathLike, step: int, t: Any) -> str:
    """Atomically write one checkpoint.  Returns the final path."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"tmp.{step}.{os.getpid()}.npz"
    final = d / f"step_{step}.npz"
    np.savez(tmp, **_flatten(t))
    os.replace(tmp, final)
    return str(final)


def latest_step(directory: str | os.PathLike) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for f in d.iterdir()
             if (m := _STEP_RE.search(f.name))]
    return max(steps) if steps else None


def restore(directory: str | os.PathLike, step: int, like: Any,
            device: str | torch.device | None = None) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor of the
    matching leaf's dtype, on ``device`` (default: that leaf's device).
    A leaf whose stored shape differs raises ``ValueError``."""
    path = pathlib.Path(directory) / f"step_{step}.npz"
    out = []
    with np.load(path) as data:
        for key, leaf in tree.flatten_with_paths(like):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key} has shape "
                                 f"{arr.shape}, expected {tuple(leaf.shape)}")
            dtype = leaf.dtype if torch.is_tensor(leaf) else None
            dev = device if device is not None else getattr(
                leaf, "device", "cpu")
            out.append(torch.from_numpy(np.array(arr)).to(dev, dtype))
    return tree.unflatten(like, out)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---- sync ----------------------------------------------------------
    def save(self, step: int, t: Any) -> str:
        path = save(self.directory, step, t)
        self._retain()
        return path

    # ---- async ---------------------------------------------------------
    def save_async(self, step: int, t: Any) -> None:
        """Copy to host now, write in the background (one write in flight
        at a time; an error surfaces at the next ``wait``)."""
        self.wait()
        host = tree.unflatten(t, [_host(x) for x in tree.leaves(t)])

        def work():
            try:
                save(self.directory, step, host)
                self._retain()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---- restore -------------------------------------------------------
    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def restore_latest(self, like: Any,
                       device: str | torch.device | None = None):
        """(step, tree) of the newest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore(self.directory, step, like, device)

    def _retain(self) -> None:
        d = pathlib.Path(self.directory)
        files = sorted((int(m.group(1)), f) for f in d.iterdir()
                       if (m := _STEP_RE.search(f.name)))
        for _, f in files[:-self.keep] if self.keep else []:
            f.unlink(missing_ok=True)
