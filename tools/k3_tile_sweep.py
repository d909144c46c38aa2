"""Sweep K3's tensor-core tiles at the shapes the engine's default path
gives it, and hold the tile planner's choice against the fastest.

    python3 tools/k3_tile_sweep.py [--out chiprun_out/k3_tile_sweep.json]

Needs a CUDA card.  Paper AlexNet (batches 8, 4, 2, 1: the serving
buckets) and YOLOv2-Tiny (batches 8, 2, 1) each run one forward under
``cuda_direct_pool`` with seeded random weights; every launch of the
tensor-core kernel (``_launch_mma``: conv1's bit-plane variant and the
+-1 layers) is recorded.  For each distinct
call, every candidate tile of ``direct_conv_bn_binarize.mma_candidates``
(up to 16 x 16 final outputs, 1-4 output words a block, within the card's
limits) is launched on the same operands, checked equal to the planner's
output bit for bit, and timed: 10 launches captured in a CUDA graph, the
graph replayed between two CUDA events, median of 3 replays (no host
time between launches enters).  Per call it prints the planner's tile and time, the
fastest tile and time, their ratio and the planner's rank among the
measured times; ``--out`` gets every tile's model cost and time, and the
last line is one JSON object of the summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import workloads  # noqa: E402
from repro_torch.kernels import direct_conv_bn_binarize as k3  # noqa: E402

REPS = 10               # launches of each tile in its graph
# (workload, batch, image height and width)
FORWARDS = [("alexnet_imagenet", 8, (227, 227)),
            ("alexnet_imagenet", 4, (227, 227)),
            ("alexnet_imagenet", 2, (227, 227)),
            ("alexnet_imagenet", 1, (227, 227)),
            ("yolov2_tiny_voc", 8, (416, 416)),
            ("yolov2_tiny_voc", 2, (416, 416)),
            ("yolov2_tiny_voc", 1, (416, 416))]


def record_calls(device) -> list[dict]:
    """The tensor-core launches of one forward per entry of FORWARDS."""
    calls, seen = [], set()
    launch = k3._launch_mma

    def spy(x, signs, const, threshold, sign_flip, cw, kh, kw, stride, pad,
            pool, planes, plan=None):
        key = (tuple(x.shape), tuple(signs.shape), kh, stride, pad,
               None if pool is None else (pool[0], pool[1], tuple(pool[2])),
               planes)
        if key not in seen:
            seen.add(key)
            calls.append(dict(key=key, args=(x, signs, const, threshold,
                                             sign_flip, cw, kh, kw, stride,
                                             pad, pool, planes)))
        return launch(x, signs, const, threshold, sign_flip, cw, kh, kw,
                      stride, pad, pool, planes, plan)

    rng = np.random.default_rng(0)
    k3._launch_mma = spy
    try:
        for name, batch, hw in FORWARDS:
            first = len(calls)
            wl = workloads.get(name, seed=0, matmul_mode="cuda_direct_pool")
            x = torch.stack([wl.preprocess_hook(
                rng.integers(0, 256, hw + (3,), dtype=np.uint8))
                for _ in range(batch)]).to(device)
            wl.engine(x)
            torch.cuda.synchronize()
            for c in calls[first:]:
                c["forward"] = f"{name} batch {batch}"
    finally:
        k3._launch_mma = launch
    return calls


def graph_ms(fn, reps: int = REPS) -> float:
    """ms a launch of ``fn``: ``reps`` launches captured in one CUDA graph,
    the graph replayed between two CUDA events (median of 3 replays), so
    no host time between launches enters."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def sweep(call: dict, limits: k3.MmaLimits) -> dict:
    x, signs, const, thr, sgn, cw, kh, kw, stride, pad, pool, planes = \
        call["args"]
    n, h, w, _ = x.shape
    oh, ow, fh, fw = k3.conv_geometry(h, w, kh, kw, stride, pad, pool)
    o = signs.shape[0]
    geo = dict(kh=kh, kw=kw, stride=stride, cw=cw, pool=pool, planes=planes,
               limits=limits)
    pick = k3.plan_mma(n, fh, fw, o, **geo)
    cands = sorted(k3.mma_candidates(n, fh, fw, o, **geo),
                   key=lambda c: c[0])
    want = k3._launch_mma(*call["args"], plan=pick)
    for _, plan in cands:
        got = k3._launch_mma(*call["args"], plan=plan)
        if not torch.equal(got, want):
            raise AssertionError(f"{call['key']}: tile {plan} != planner's "
                                 f"tile {pick}")
    times = [graph_ms(functools.partial(k3._launch_mma, *call["args"],
                                        plan=plan)) for _, plan in cands]
    rows = [dict(tile=[plan.tile_h, plan.tile_w, plan.nw_block], model=cost,
                 ms=ms) for (cost, plan), ms in zip(cands, times)]
    by_ms = sorted(rows, key=lambda r: r["ms"])
    mine = next(r for r in rows
                if r["tile"] == [pick.tile_h, pick.tile_w, pick.nw_block])
    return dict(forward=call["forward"], x=list(x.shape), o=o,
                kernel=kh, stride=stride, pad=pad, pool=pool,
                planes=planes, candidates=len(rows),
                planner=dict(tile=mine["tile"], ms=mine["ms"],
                             rank=by_ms.index(mine) + 1),
                best=dict(tile=by_ms[0]["tile"], ms=by_ms[0]["ms"]),
                ratio=mine["ms"] / by_ms[0]["ms"],
                tiles=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/k3_tile_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    limits = k3.mma_limits(device)
    print(f"limits {limits}", flush=True)
    results = []
    for call in record_calls(device):
        r = sweep(call, limits)
        results.append(r)
        print(f"{r['forward']} x{tuple(r['x'])} {r['kernel']}x{r['kernel']}"
              f"/{r['stride']} O {r['o']} pool {r['pool']} planes "
              f"{r['planes']}: {r['candidates']} tiles, planner "
              f"{r['planner']['tile']} {r['planner']['ms']:.4f} ms (rank "
              f"{r['planner']['rank']}), best {r['best']['tile']} "
              f"{r['best']['ms']:.4f} ms, ratio {r['ratio']:.3f}",
              flush=True)
    out = dict(device=smi, limits=dataclasses.asdict(limits),
               weights=dataclasses.asdict(k3.MMA_WEIGHTS),
               seconds=time.perf_counter() - t0, calls=results)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(device=smi, calls=[
        dict(forward=r["forward"], x=r["x"], o=r["o"],
             planner=r["planner"], best=r["best"], ratio=r["ratio"])
        for r in results])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
