"""The pipeline-parallel serving placement (DESIGN.md §13).

Counterpart of ``repro.distributed.pipeline``.  The cut planner and the
staged executor live in :mod:`repro_torch.runtime.placement`; this module
is the placement object the server takes:

    server = InferenceServer(engine, placement=Pipelined.over(2))

``InferenceServer`` duck-types placements on ``.kind``: ``"pipeline"``
builds every bucket through ``engine.compile(..., pipeline=devices)``.  A
one-device ``Pipelined`` is the degenerate-but-useful case, one stage
with its params on that device: how
:class:`~repro_torch.distributed.replicas.ReplicaGroup` pins a replica.
A device may be listed more than once (``(cuda:0, cuda:0)`` stages one
card's forward).

Stage boundaries are exact handoffs, so a pipelined server's rows equal
the single-device ``cross_check`` bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch


def visible_cards() -> tuple[torch.device, ...]:
    """``cuda:i`` for every card torch sees (none without a card)."""
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class Pipelined:
    """Pipeline placement: stage the graph over ``devices``.  The plan may
    have fewer stages than devices when the graph offers fewer legal
    cuts; the surplus devices go unused (the executor's
    ``stage_report()`` shows the split)."""

    devices: tuple[Any, ...]
    kind = "pipeline"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("Pipelined needs at least one device")
        object.__setattr__(self, "devices", tuple(self.devices))

    @classmethod
    def over(cls, n_stages: int, devices: Sequence[Any] | None = None
             ) -> "Pipelined":
        """The first ``n_stages`` of ``devices`` (default: every visible
        card, never the CPU)."""
        devices = tuple(devices if devices is not None else visible_cards())
        if n_stages < 1 or n_stages > len(devices):
            raise ValueError(f"n_stages={n_stages} outside 1.."
                             f"{len(devices)} visible devices")
        return cls(devices[:n_stages])

    @property
    def n_stages(self) -> int:
        return len(self.devices)
