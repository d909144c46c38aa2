"""Fit K3's tile-planner weights to a tile sweep, and score the planner's.

    python3 tools/k3_tile_fit.py chiprun_out/k3_tile_sweep.json

Reads what ``tools/k3_tile_sweep.py`` measured (every candidate tile of
every tensor-core call on the default path, its device time) and runs on
the CPU.  For a set of ``direct_conv_bn_binarize.MmaWeights`` it replays
the planner (``mma_candidates`` and ``plan_mma``'s tie rule) on each call
and reads the measured time of the tile it would pick, over the fastest
measured tile.  It prints those ratios for the weights in the code, then
grid-searches the weights (least worst ratio, then least sum of log
ratios) on all calls, and on all calls but one forward each, scored on
the forward left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import direct_conv_bn_binarize as k3  # noqa: E402

GRID = dict(plane_word=(0.125, 0.25, 0.5, 1.0, 2.0),
            pm1_word=(0.0, 0.00625, 0.0125, 0.025, 0.05),
            filter_word=(0.0, 0.0125, 0.025, 0.05, 0.1))


def limits_of(sweep: dict) -> k3.MmaLimits:
    lim = sweep["limits"]
    if isinstance(lim, str):            # a repr, as older sweeps wrote it
        lim = {k: int(re.search(rf"{k}=(\d+)", lim).group(1))
               for k in ("sms", "smem_block")}
    return k3.MmaLimits(lim["sms"], lim["smem_block"])


def calls_of(sweep: dict) -> list[dict]:
    """Each call's planner arguments and measured ms by tile."""
    out = []
    for c in sweep["calls"]:
        n, h, w, xw = c["x"]
        pool = None if c["pool"] is None else (
            c["pool"][0], c["pool"][1], tuple(c["pool"][2]))
        k = c["kernel"]
        _, _, fh, fw = k3.conv_geometry(h, w, k, k, c["stride"], c["pad"],
                                        pool)
        out.append(dict(
            forward=c["forward"], args=(n, fh, fw, c["o"]),
            geo=dict(kh=k, kw=k, stride=c["stride"],
                     cw=xw // 8 if c["planes"] else xw, pool=pool,
                     planes=c["planes"]),
            ms={tuple(t["tile"]): t["ms"] for t in c["tiles"]}))
    return out


def ratios(calls: list[dict], limits, weights) -> list[float]:
    """Measured ms of the tile the planner picks under ``weights``, over
    the fastest measured tile, per call."""
    out = []
    for c in calls:
        cands = k3.mma_candidates(*c["args"], limits=limits, weights=weights,
                                  **c["geo"])
        _, plan = min(cands, key=lambda x: (x[0], -x[1].tile_h
                                            * x[1].tile_w, -x[1].nw_block))
        out.append(c["ms"][(plan.tile_h, plan.tile_w, plan.nw_block)]
                   / min(c["ms"].values()))
    return out


def score(r: list[float]) -> tuple[float, float]:
    return round(max(r), 3), sum(math.log(x) for x in r)


def fit(calls, limits) -> tuple[k3.MmaWeights, list[float]]:
    best = None
    for vals in itertools.product(*GRID.values()):
        w = k3.MmaWeights(**dict(zip(GRID, vals)))
        r = ratios(calls, limits, w)
        if best is None or score(r) < score(best[1]):
            best = (w, r)
    return best


def show(name: str, r: list[float]) -> None:
    print(f"{name}: worst {max(r):.3f}, geometric mean "
          f"{math.exp(sum(map(math.log, r)) / len(r)):.4f}, per call "
          f"{[round(x, 3) for x in r]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep", help="JSON written by tools/k3_tile_sweep.py")
    args = ap.parse_args()
    sweep = json.loads(pathlib.Path(args.sweep).read_text())
    limits, calls = limits_of(sweep), calls_of(sweep)
    print(f"{len(calls)} calls, {sum(len(c['ms']) for c in calls)} tiles, "
          f"{sweep['device']}")
    show(f"weights in the code {dataclasses.asdict(k3.MMA_WEIGHTS)}",
         ratios(calls, limits, k3.MMA_WEIGHTS))
    w, r = fit(calls, limits)
    show(f"grid best on all calls {dataclasses.asdict(w)}", r)
    for fwd in sorted({c["forward"] for c in calls}):
        train = [c for c in calls if c["forward"] != fwd]
        test = [c for c in calls if c["forward"] == fwd]
        w, _ = fit(train, limits)
        show(f"fit without {fwd} {dataclasses.asdict(w)}, on {fwd}",
             ratios(test, limits, w))
    return 0


if __name__ == "__main__":
    sys.exit(main())
