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
into.  ``restore(..., device=)`` places the leaves.

On a mesh (``rules`` and a spec tree, one process a rank) ``save`` puts
each leaf back together from the ranks' shards and rank 0 writes the
file: full host arrays, as the reference's.  ``restore`` with ``rules``
and ``specs`` is the elastic restore: each rank reads its own slice of
every leaf under the current mesh, whatever mesh saved it (the
reference's ``restore(..., shardings)``); ``like`` holds the full shapes,
e.g. ``transformer.abstract_params``' meta tensors.

The archive is not compressed (the reference's is; ``np.load`` reads
both): float32 weights and moments shrink by some 7%
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
from repro_torch.distributed import sharding

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


def save(directory: str | os.PathLike, step: int, t: Any, rules=None,
         specs: Any = None) -> str:
    """Atomically write one checkpoint.  Returns the final path.  With
    ``rules`` and ``specs`` every rank calls it with its shards; the
    leaves are gathered, rank 0 writes, and every rank returns once the
    file is in place."""
    if rules is not None:
        full = [sharding.gather(x, s, rules)
                for x, s in zip(tree.leaves(t), tree.leaves(specs))]
        world = rules.comm(tuple(rules.mesh.axis_names))
        path = None
        if world.index == 0:
            path = save(directory, step, tree.unflatten(t, full))
        del full
        world.psum(torch.zeros(1, device=rules.device))    # a barrier
        return path or str(pathlib.Path(directory) / f"step_{step}.npz")
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
            device: str | torch.device | None = None, *, rules=None,
            specs: Any = None) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor of the
    matching leaf's dtype, on ``device`` (default: ``rules``' device, else
    that leaf's, a meta leaf's the CPU).  A leaf whose stored shape
    differs from ``like``'s raises ``ValueError``.  With ``rules`` and
    ``specs``: this rank's slice of each leaf under its spec."""
    path = pathlib.Path(directory) / f"step_{step}.npz"
    spec_leaves = (tree.leaves(specs) if specs is not None
                   else [None] * len(tree.leaves(like)))
    if device is None and rules is not None:
        device = rules.device
    out = []
    with np.load(path) as data:
        for (key, leaf), spec in zip(tree.flatten_with_paths(like),
                                     spec_leaves):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key} has shape "
                                 f"{arr.shape}, expected {tuple(leaf.shape)}")
            dtype = leaf.dtype if torch.is_tensor(leaf) else None
            dev = device if device is not None else getattr(
                leaf, "device", "cpu")
            if torch.device(dev).type == "meta":
                dev = "cpu"
            t = torch.from_numpy(np.array(arr))
            if spec is not None:
                t = sharding.local_shard(t, spec, rules)
            out.append(t.to(dev, dtype).contiguous())
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
