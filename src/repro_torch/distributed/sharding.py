"""The data-parallel serving placement (DESIGN.md §13).

Counterpart of ``DataParallel`` in ``repro.distributed.sharding``.  The
reference shards each bucket's batch dim over a mesh axis inside one XLA
executable.  Torch has no such executable, so the port names the shards'
devices: the server rounds each bucket up to a multiple of the shard
count, and ``engine.compile(..., data_parallel=devices)`` splits the
padded bucket into equal row shards, runs one executor a device at
``bucket // n`` and gathers the rows on the first device
(:class:`~repro_torch.runtime.placement.ShardedExecutor`).  The rows equal
the single-device forward's bit for bit.

The reference's LM sharding rules (``Rules``, ``rules_for_mesh``) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.distributed.pipeline import visible_cards


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """Data-parallel placement: one row shard of every bucket a device of
    ``devices`` (a card may be listed more than once)."""

    devices: tuple[Any, ...]
    kind = "data"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("DataParallel needs at least one device")
        object.__setattr__(self, "devices", tuple(self.devices))

    @classmethod
    def over(cls, n_shards: int, devices: Sequence[Any] | None = None
             ) -> "DataParallel":
        """The first ``n_shards`` of ``devices`` (default: every visible
        card, never the CPU)."""
        devices = tuple(devices if devices is not None else visible_cards())
        if n_shards < 1 or n_shards > len(devices):
            raise ValueError(f"n_shards={n_shards} outside 1.."
                             f"{len(devices)} visible devices")
        return cls(devices[:n_shards])

    @property
    def n_shards(self) -> int:
        return len(self.devices)
