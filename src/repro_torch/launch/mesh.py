"""Host meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

The reference builds a ``jax.sharding.Mesh`` over the devices of one
process and lets XLA partition a program over it.  The port runs one
process a rank (SPMD): every rank runs the same code on its own shards and
meets the others in explicit collectives.  :func:`make_host_mesh` names
the ranks of the initialised process group as a ``(data, model)`` or
``(pod, data, model)`` grid, row-major as the reference's mesh orders its
devices, over a ``torch.distributed.device_mesh.DeviceMesh`` (one process
group an axis) plus one group for each set of two or more axes; a
collective over a set of axes runs on that set's group.

The backend is chosen when the group is initialised and printed with the
mesh:

* ``nccl`` when every rank of the host has a card of its own;
* ``gloo`` when ranks share a card (NCCL refuses two ranks on one card):
  every collective on a CUDA tensor then goes through pinned host memory,
  copied there and back by the port itself (``Mesh.staged``);
* ``gloo`` on the CPU;
* ``fake`` for the dry-run (:func:`make_production_mesh`,
  :func:`fake_group`): one process plays one rank of a group whose
  collectives move nothing (``torch.distributed``'s fake process group),
  and the tensors are fakes (``FakeTensorMode``) that only claim a
  device.

A rank's device is ``cuda:(local_rank % device_count)`` unless the caller
asks for the CPU; on a fake group it is only a name.

Four ways in: :func:`init_from_env` under ``torchrun``; :func:`spawn`,
which starts N ranks on this host with a ``file://`` rendezvous (tests
and the chip smoke); :func:`fake_group` (the dry-run's production meshes,
16×16 and 2×16×16); and one process with no group, whose mesh has every
axis of size 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import pickle
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Collective


def _local_world() -> tuple[int, int]:
    """(local rank, ranks on this host) from torchrun's environment, or
    this process alone."""
    return (int(os.environ.get("LOCAL_RANK", 0)),
            int(os.environ.get("LOCAL_WORLD_SIZE", 1)))


def rank_device(device: str | torch.device = "cuda",
                local_rank: int | None = None) -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` for
    ``"cuda"`` (a missing card is an error), the CPU on request."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if device.index is not None:
        return device
    local = _local_world()[0] if local_rank is None else local_rank
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when every rank of the host has a card of its own, else
    ``gloo`` (ranks sharing a card, or on the CPU)."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init_group(init_method: str, rank: int, world: int,
                device: torch.device, local_world: int) -> str:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(device, local_world)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return backend


def init_from_env(device: str | torch.device = "cuda") -> torch.device:
    """Initialise the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it is set; returns this rank's device.  Without
    torchrun it initialises nothing (one process, one device)."""
    local, local_world = _local_world()
    dev = rank_device(device, local)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and not dist.is_initialized():
        _init_group("env://", int(os.environ["RANK"]),
                    int(os.environ["WORLD_SIZE"]), dev, local_world)
    return dev


@dataclasses.dataclass
class Mesh:
    """A named grid of the process group's ranks (row-major), this rank's
    place in it, and the groups its collectives run on."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    device: torch.device
    backend: str | None               # None: one process, no group
    staged: bool                      # CUDA collectives through the host
    device_mesh: Any = None           # torch DeviceMesh (world > 1)
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def coordinate(self, axes) -> int:
        """This rank's row-major index over ``axes`` (0 over none)."""
        index, rest = 0, self.rank
        coords = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            coords[name] = rest % n
            rest //= n
        for name in self._axes(axes):
            index = index * self.shape[name] + coords[name]
        return index

    def comm(self, axes) -> Collective:
        """The collectives over ``axes`` (a name or a tuple of names)."""
        axes = self._axes(axes)
        n = math.prod(self.shape[a] for a in axes)
        return Collective(self.groups.get(axes), n, self.coordinate(axes),
                          self.staged)

    def describe(self) -> str:
        grid = " x ".join(f"{a} {n}" for a, n in self.shape.items())
        how = ("one process" if self.backend is None else
               f"backend {self.backend}"
               + (", collectives staged through pinned host memory"
                  if self.staged else ""))
        return f"mesh {grid} on {self.device} ({how})"


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device: str | torch.device | None = None) -> Mesh:
    """A ``(data, model)`` mesh, or ``(pod, data, model)`` with ``pod``,
    over the initialised process group (its size must be the grid's), or
    over this process alone when the grid has one rank.  ``device``:
    this rank's (default: ``cuda:(local_rank % device_count)``)."""
    names = ("pod", "data", "model") if pod else ("data", "model")
    sizes = (pod, data, model) if pod else (data, model)
    world = math.prod(sizes)
    fake = dist.is_initialized() and dist.get_backend() == "fake"
    if fake:                      # a name: the tensors are fakes
        device = torch.device("cuda" if device is None else device)
    else:
        device = rank_device("cuda" if device is None else device)
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError(f"a {sizes} mesh needs {world} ranks: "
                               f"initialise the process group first "
                               f"(init_from_env under torchrun, or spawn)")
        return Mesh(names, sizes, 0, device, None, False)
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {sizes} has {world} ranks, the process "
                         f"group {dist.get_world_size()}")
    backend = dist.get_backend()
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", sizes,
                          mesh_dim_names=names)
    groups = {(name,): dm.get_group(name) for name in names}
    # One group for each set of two or more axes, made by every rank in
    # the same order; the full set is the world.
    for k in range(2, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if k == len(names):
                groups[axes] = dist.group.WORLD
                continue
            groups[axes] = _subset_group(names, sizes, axes)
    staged = backend == "gloo" and device.type == "cuda"
    return Mesh(names, sizes, dist.get_rank(), device, backend, staged, dm,
                groups)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """This process as rank ``rank`` of a process group of ``world`` ranks
    whose collectives move nothing (backend ``fake``), destroyed on
    leaving the block.  For tracing one rank's program under
    ``FakeTensorMode``: what each collective is handed is recorded
    (``Collective.recording``), nothing is sent."""
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already "
                           "initialised in this process")
    _init_fake(world, rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _init_fake(world: int, rank: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


#: The reference's production meshes (``repro.launch.mesh``): one pod of
#: 16×16 chips, or two.
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0,
                         device: str | torch.device = "cuda") -> Mesh:
    """Rank ``rank``'s view of the 16×16 ``(data, model)`` mesh or, with
    ``multi_pod``, the 2×16×16 ``(pod, data, model)`` one, over a fake
    process group of 256 or 512 ranks in this one process (the one
    :func:`fake_group` opened, or one this opens and leaves open when no
    group is initialised).  Collectives are not staged, as under NCCL
    with one card a rank.  ``device`` names where the fake tensors claim
    to live: ``cuda`` routes attention through K7's and K7b's fakes,
    ``cpu`` through their plain versions."""
    sizes, names = PRODUCTION_MESHES[multi_pod]
    world = math.prod(sizes)
    if not dist.is_initialized():
        _init_fake(world, rank)
    if dist.get_backend() != "fake" or dist.get_world_size() != world:
        raise RuntimeError(f"make_production_mesh: needs a fake process "
                           f"group of {world} ranks")
    return make_host_mesh(**dict(zip(names, sizes)), device=device)


def _subset_group(names, sizes, axes):
    """This rank's group over ``axes``: the ranks that share its
    coordinates on the other axes, in row-major order."""
    strides = {}
    s = 1
    for name, n in reversed(list(zip(names, sizes))):
        strides[name] = s
        s *= n
    others = [a for a in names if a not in axes]
    lists = []
    for fixed in itertools.product(*(range(sizes[names.index(a)])
                                     for a in others)):
        base = sum(c * strides[a] for a, c in zip(others, fixed))
        ranks = [base + sum(c * strides[a] for a, c in zip(axes, cs))
                 for cs in itertools.product(*(range(sizes[names.index(a)])
                                               for a in axes))]
        lists.append(sorted(ranks))
    mine, _ = dist.new_subgroups_by_enumeration(lists)
    return mine


# --------------------------------------------------------------------------
# Spawning ranks on one host
# --------------------------------------------------------------------------

def _rank_main(rank: int, world: int, tmp: str, device: str,
               threads: int | None) -> None:
    if threads:
        torch.set_num_threads(threads)
    with open(os.path.join(tmp, f"args{rank}.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dev = rank_device(device, rank)
    _init_group(f"file://{os.path.join(tmp, 'rendezvous')}", rank, world,
                dev, world)
    try:
        result = fn(rank, dev, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device: str = "cuda",
          timeout_s: float = 600.0, threads: int | None = None,
          workdir: str | None = None) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` new processes of this
    host, each a rank of one process group (``file://`` rendezvous under
    ``workdir``, backend by :func:`choose_backend`); returns each rank's
    return value (picklable), by rank.  ``args`` may hold CUDA tensors:
    the ranks receive them through CUDA IPC, without a copy (this process
    keeps them alive until the ranks end).  A rank that raises makes this
    raise its error; a run past ``timeout_s`` is terminated and raises
    ``TimeoutError``."""
    import torch.multiprocessing as mp
    from multiprocessing.reduction import ForkingPickler

    with tempfile.TemporaryDirectory(prefix="mesh-", dir=workdir) as tmp:
        # The arguments go through a file a rank, not the start pipe: a
        # large pipe write waits for its child to boot, which would start
        # the ranks one after another.
        for r in range(world):
            with open(os.path.join(tmp, f"args{r}.pkl"), "wb") as f:
                f.write(ForkingPickler.dumps((fn, args)))
        ctx = mp.start_processes(
            _rank_main, args=(world, tmp, device, threads), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, min(
                    5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running "
                                       f"after {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
