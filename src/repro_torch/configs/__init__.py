"""Architecture registry (counterpart of ``repro.configs``): ``get(arch_id)``
for every architecture the reference assigns — the four LM archs and the
vision and diffusion zoo.

Each arch module exports FULL (the published config), SMOKE (a reduced
config of the same family for CPU tests), FAMILY and SHAPES (its family's
table in :mod:`repro_torch.configs.shapes`).  ``all_cells()`` enumerates
the 40 (arch × shape) cells, skips included.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from repro_torch.configs.shapes import Shape

ARCH_IDS = (
    "granite-moe-3b-a800m",
    "qwen3-moe-30b-a3b",
    "minitron-8b",
    "command-r-35b",
    "dit-l2",
    "dit-xl2",
    "efficientnet-b7",
    "convnext-b",
    "vit-l16",
    "vit-h14",
)


@dataclasses.dataclass(frozen=True)
class ArchRecord:
    arch_id: str
    family: str
    full: Any
    smoke: Any
    shapes: tuple[Shape, ...]

    def shape(self, name: str) -> Shape:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")


def get(arch_id: str) -> ArchRecord:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))
    return ArchRecord(arch_id=arch_id, family=mod.FAMILY, full=mod.FULL,
                      smoke=mod.SMOKE, shapes=tuple(mod.SHAPES))


def all_cells() -> list[tuple[str, Shape]]:
    """All 40 (arch, shape) cells, skips included."""
    return [(arch_id, shape) for arch_id in ARCH_IDS
            for shape in get(arch_id).shapes]
