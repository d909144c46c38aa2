"""Benchmark provenance: the ``meta`` block a BENCH artifact carries
(DESIGN.md §10.5).

Counterpart of ``repro.obs.provenance``.  A number without its context —
which commit, which torch and CUDA, which card — cannot be compared
across runs.  :func:`stamp` adds a ``meta`` dict with the git sha, the
torch and CUDA versions, the device's name and count, a timestamp and the
executor's backend list; :func:`write_bench` is the one write path for a
stamped report.  The trace export (:meth:`~repro_torch.obs.trace.Tracer.
to_chrome`) carries the same block.

Everything is best-effort: a missing git binary or no card yields
``None`` fields, never a failed run.
"""

from __future__ import annotations

import datetime
import json
import pathlib
import platform
import subprocess
import sys

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

META_SCHEMA = "bench-meta-v1"


def git_revision(root: pathlib.Path | None = None
                 ) -> tuple[str | None, bool | None]:
    """(sha, dirty) of the repo containing this package; (None, None)
    when git is unavailable."""
    cwd = root or _REPO_ROOT
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip())
        return sha, dirty
    except (OSError, subprocess.SubprocessError):
        return None, None


def provenance_meta() -> dict:
    """The meta block: enough to compare two measurements honestly."""
    import torch

    from repro_torch.runtime.executor import ALL_MODES

    if torch.cuda.is_available():
        device_kind = torch.cuda.get_device_name(0)
        n_devices = torch.cuda.device_count()
    else:
        device_kind, n_devices = None, 0
    sha, dirty = git_revision()
    return {
        "schema": META_SCHEMA,
        "git_sha": sha,
        "git_dirty": dirty,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if n_devices else "cpu",
        "device_kind": device_kind,
        "n_devices": n_devices,
        "backends": list(ALL_MODES),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
                             .isoformat(timespec="seconds"),
    }


def stamp(report: dict) -> dict:
    """A copy of ``report`` carrying the provenance ``meta`` block."""
    return dict(report, meta=provenance_meta())


def write_bench(path, report: dict, *, sort_keys: bool = False) -> dict:
    """Stamp and write one report as JSON; returns the stamped report."""
    stamped = stamp(report)
    with open(path, "w") as f:
        json.dump(stamped, f, indent=1, sort_keys=sort_keys)
        f.write("\n")
    return stamped
