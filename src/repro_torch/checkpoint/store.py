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
caller's thread and writes it in the background.  A manager with
``rules`` and ``specs`` is one rank's (every rank makes one and calls it
alike): ``save`` / ``save_async`` gather every leaf on every rank and rank
0 writes, in the background for ``save_async``; ``wait`` also waits for
every rank; ``restore_latest`` gives each rank its slices under the
current mesh (a restart on another mesh resumes: the reference's elastic
re-mesh).  Its ``like`` holds the current mesh's full shapes (its expert
and vocab padding), so a checkpoint padded otherwise raises
``ValueError``, as the reference's restore does.
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


def _writer(rules) -> bool:
    return rules is None or rules.comm(tuple(rules.mesh.axis_names)) \
        .index == 0


def _barrier(rules) -> None:
    rules.comm(tuple(rules.mesh.axis_names)).psum(
        torch.zeros(1, device=rules.device))


def _gathered_host(t: Any, rules, specs: Any) -> Any:
    """Each leaf of ``t`` put back together from the ranks' slices (every
    rank takes part, a leaf at a time), as host arrays on rank 0; None on
    the other ranks."""
    first = _writer(rules)
    out = []
    for x, s in zip(tree.leaves(t), tree.leaves(specs)):
        full = sharding.gather(x, s, rules)
        out.append(_host(full) if first else None)
    return tree.unflatten(t, out) if first else None


def save(directory: str | os.PathLike, step: int, t: Any, rules=None,
         specs: Any = None) -> str:
    """Atomically write one checkpoint.  Returns the final path.  With
    ``rules`` and ``specs`` every rank calls it with its shards; the
    leaves are gathered, rank 0 writes, and every rank returns once the
    file is in place."""
    if rules is not None:
        host = _gathered_host(t, rules, specs)
        path = save(directory, step, host) if host is not None else None
        _barrier(rules)
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
    """Checkpoints of one job under ``directory``, the last ``keep``
    kept.  With ``rules`` and ``specs`` (the spec tree of the trees it
    saves: e.g. ``{"params": specs, "opt": OptState(P(), specs,
    specs)}``) it is one rank's manager (see the module's docstring)."""
    directory: str
    keep: int = 3
    rules: Any = None
    specs: Any = None

    def __post_init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---- sync ----------------------------------------------------------
    def save(self, step: int, t: Any) -> str:
        path = save(self.directory, step, t, self.rules, self.specs)
        if _writer(self.rules):
            self._retain()
        return path

    # ---- async ---------------------------------------------------------
    def save_async(self, step: int, t: Any) -> None:
        """Copy to host now, write in the background (one write in flight
        at a time; an error surfaces at the next ``wait``).  With
        ``rules``: gathered on every rank now, written by rank 0."""
        self.wait()
        if self.rules is not None:
            host = _gathered_host(t, self.rules, self.specs)
            if host is None:
                return
        else:
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
        """Until the write in flight is done (with ``rules``: on every
        rank, so that each may then exit)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.rules is not None:
            _barrier(self.rules)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---- restore -------------------------------------------------------
    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def restore_latest(self, like: Any,
                       device: str | torch.device | None = None):
        """(step, tree) of the newest checkpoint, or (None, None).  With
        ``rules``: this rank's slices under the current mesh, ``like``
        holding the full shapes (``sharding.full_like``)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore(self.directory, step, like, device,
                             rules=self.rules, specs=self.specs)

    def _retain(self) -> None:
        d = pathlib.Path(self.directory)
        files = sorted((int(m.group(1)), f) for f in d.iterdir()
                       if (m := _STEP_RE.search(f.name)))
        for _, f in files[:-self.keep] if self.keep else []:
            f.unlink(missing_ok=True)
