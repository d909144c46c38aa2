#!/usr/bin/env python3
"""Summarise runs of ``tools/k7b_probe.py`` on two trees.

Reads the probe's ``--out`` JSON files, groups them by the tree they ran
(``src``), and for each timed shape prints K7b's and K7's serving
launch's device time on each tree (runs, min, quartiles, median, max),
then pairs the trees' runs in the order given (the i-th run of the first
tree with the i-th of the second) and counts the pairs the second tree
wins and loses.  Runs alternate best as parent, change, change, parent:

    python3 tools/probe_compare.py chiprun_out/probe_*.json
"""

from __future__ import annotations

import argparse
import json
import statistics


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+", help="the probe's JSON files")
    args = ap.parse_args()
    runs: dict[str, list[dict]] = {}
    for path in args.files:
        with open(path) as f:
            d = json.load(f)
        if d["mismatches"]:
            print(f"{path}: {d['mismatches']} mismatches")
        runs.setdefault(d["src"], []).append(d)
    trees = list(runs)
    print("card:", sorted({d["card"] for r in runs.values() for d in r}))
    shapes = [row["shape"] for row in runs[trees[0]][0]["rows"]]
    for shape in shapes:
        for metric, key in (("K7b", "device_ms"), ("K7", "k7_device_ms")):
            times = {t: [next(r[key] for r in d["rows"]
                              if r["shape"] == shape) for d in runs[t]]
                     for t in trees}
            for t in trees:
                x = times[t]
                q1, _, q3 = statistics.quantiles(x, n=4)
                print(f"{shape} {metric} {t}: {len(x)} runs, min "
                      f"{min(x):.4f}, quartiles {q1:.4f}-{q3:.4f}, median "
                      f"{statistics.median(x):.4f}, max {max(x):.4f} ms")
            if len(trees) == 2:
                a, b = times[trees[0]], times[trees[1]]
                wins = sum(y < x for x, y in zip(a, b))
                losses = sum(y > x for x, y in zip(a, b))
                change = statistics.median(b) / statistics.median(a) - 1
                print(f"{shape} {metric}: the second tree faster in {wins} "
                      f"of {min(len(a), len(b))} pairs, slower in {losses}; "
                      f"medians {100 * change:+.2f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
