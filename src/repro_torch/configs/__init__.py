"""Architecture registry (counterpart of ``repro.configs``) for the
architectures the port runs: the reference's four LM archs.

Each arch module exports FULL (the published config), SMOKE (a reduced
config of the same family for CPU tests) and FAMILY.  ``get(arch_id)``
knows only the ported archs; the reference's other archs raise
``KeyError``.  The reference's dry-run shape tables are not ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

#: Archs the port runs.
ARCH_IDS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "minitron-8b",
            "command-r-35b")


@dataclasses.dataclass(frozen=True)
class ArchRecord:
    arch_id: str
    family: str
    full: Any
    smoke: Any


def get(arch_id: str) -> ArchRecord:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"arch {arch_id!r} is not ported yet; the port runs "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))
    return ArchRecord(arch_id=arch_id, family=mod.FAMILY, full=mod.FULL,
                      smoke=mod.SMOKE)
