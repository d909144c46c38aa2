#!/usr/bin/env python3
"""The dry-run's cached reports as one markdown table, a row a cell and
the two production meshes side by side: the three roofline terms in ms
(the bounding one named where it is not the collective term) and the
peak in GiB a rank, as
``repro_torch.launch.dryrun`` wrote them (H100 SXM constants; no figure
is a time measured on a card).

    python3 tools/dryrun_table.py [artifacts/dryrun_torch]
"""

import json
import pathlib
import sys


def cell(r: dict | None) -> str:
    if r is None:
        return "not traced"
    if r.get("failed"):
        return "FAILED"
    star = "" if r["bottleneck"] == "collective" else f" ({r['bottleneck']})"
    return (f"{r['t_compute'] * 1e3:.3g} / {r['t_memory'] * 1e3:.4g} / "
            f"{r['t_collective'] * 1e3:.4g}{star}, "
            f"{r['peak_memory_bytes'] / 2**30:.3g}")


def main() -> int:
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                       else "artifacts/dryrun_torch")
    rows: dict = {}
    skipped = []
    for f in sorted(out.glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("skipped"):
            skipped.append(f"{r['arch']} {r['shape']} ({r['mesh']})")
            continue
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    print("| cell | 16×16: t_c / t_m / t_n ms, peak GiB | 2×16×16 |")
    print("|---|---|---|")
    for (arch, shape), by in rows.items():
        print(f"| {arch} {shape} | {cell(by.get('16x16'))} | "
              f"{cell(by.get('2x16x16'))} |")
    print(f"\n{len(skipped)} skipped: " + ", ".join(skipped))
    return 0


if __name__ == "__main__":
    sys.exit(main())
