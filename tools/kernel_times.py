#!/usr/bin/env python3
"""Kernel and forward times of one tree's port, by ``chip_smoke.py``.

Runs this checkout's ``chip_smoke.py`` against the ``repro_torch`` package
under ``--src``: one AlexNet forward and head at batch 8 on each image
serving path, as that tree serves it (its ``compile(8)``: eager, or one
CUDA-graph replay where the tree captures its buckets), through the
script's ``profile_forward`` (host wall, device time a forward by kernel,
busy share, peak memory), then its timing phase (each kernel at
AlexNet's batch-8 shapes, K7 at minitron's prefill layer, and at
granite's where the tree takes head width 64, and K7b at lm-100m's layer
and minitron's prefill layer, each launch apart, beside SDPA's backward
with each backend pinned: the single-call CUDA-event median and the
device time a call from torch.profiler, beside the plain version and the
bound).  Two trees (a parent and a change) are so timed by one method,
in one process each.  Needs one CUDA card; builds that tree's kernels
into its own ``build/``.  ``tools/k7b_probe.py --src`` times K7b alone
at the same two shapes, in well under a minute.

    python3 tools/kernel_times.py [--src OTHER_TREE/src] [--out FILE.json]

The script's imports and timing phase name the training path's modules
and K7b, so ``--src`` takes a tree that has them (from the training
slice on).

Last, K6's device time a call at AlexNet's conv2-fc7 for the buckets
below 8 (``cuda_pm1`` serves 1, 2 and 4), through the tree's wrapper.
Prints the ``[profile]``, ``[timing]`` and ``[buckets]`` lines, a
``[profiler]`` line for each session that missed records, and the
forwards, kernel and bucket rows as JSON (to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def bucket_times(cs, device) -> list[dict]:
    """K6 (``mxu_pm1_matmul``) at conv2-fc7 for batches 1, 2 and 4, device
    ms a call (``chip_smoke.device_ms``; None where the profiler recorded
    no kernel)."""
    from repro_torch.core import packing
    from repro_torch.kernels import mxu_pm1_matmul as k6
    inp = cs.Inputs(device, seed=5)
    rows = []
    for name, (_, h, w, c), k, st, pad, o, _ in cs.ALEXNET_MATMULS[1:]:
        oh, ow = (cs.conv_out_size(d, k, st, pad) for d in (h, w))
        words = k * k * packing.num_words(c)
        for batch in (1, 2, 4):
            m = batch * oh * ow
            a, b = inp.words(m, words), inp.words(o, words)
            what = f"mxu_pm1_matmul {name} batch {batch} ({m}, {o}, {words})"
            try:
                ms = cs.device_ms(lambda: k6.mxu_pm1_matmul(a, b, 32 * words))
            except RuntimeError as e:       # the profiler saw nothing
                ms = None
                cs.log(f"[buckets] {what}: not measured ({e})")
            else:
                cs.log(f"[buckets] {what}: device {ms:.4f} ms")
            rows.append(dict(layer=name, batch=batch, m=m, n=o, w=words,
                             device_ms=ms))
    return rows


def served_forward(cs, workloads, mode: str) -> dict:
    """AlexNet's bucket-8 forward and head on ``mode`` as the tree under
    test serves it, profiled by ``chip_smoke.profile_forward``."""
    import torch
    wl = workloads.get("alexnet_imagenet", seed=0, matmul_mode=mode)
    x = torch.randint(0, 256, (cs.BATCH, *wl.input_hw, 3),
                      dtype=torch.uint8, device=wl.engine.device)
    r = cs.profile_forward(wl.engine.compile(cs.BATCH), x)
    cs.log(f"[profile] {mode} forward + head at batch {cs.BATCH}, served "
           f"form: host wall {r['wall_ms']:.4f} ms/forward (no profiler), "
           f"device {r['device_ms']:.4f} ms/forward, busy share "
           f"{r['busy_share']:.3f}, peak device memory {r['peak_bytes']} B")
    for row in r["rows"]:
        cs.log(f"[profile]   {row['ms']:.4f} ms  x{row['per_forward']:g}  "
               f"{row['kernel']}")
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the tree to time")
    ap.add_argument("--out", help="write the kernel rows here as JSON")
    args = ap.parse_args()
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch                      # the tree under test, first
    import repro_torch.workloads
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device")
        return 1
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, "
                           f"not {src}")
    sys.path.insert(0, str(ROOT))
    import chip_smoke                       # reuses the package above
    from repro_torch.kernels import flash_attention as k7
    # A tree from before K7's head width 64 has no KERNEL_HEAD_DIMS and
    # takes hd 128 alone.
    widths = getattr(k7, "KERNEL_HEAD_DIMS", (128,))
    chip_smoke.FLASH_TIMED = tuple(c for c in chip_smoke.FLASH_TIMED
                                   if c[6] in widths)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[kernel_times] {src}: {smi}", flush=True)
    forwards = {mode: served_forward(chip_smoke, repro_torch.workloads,
                                     mode)
                for mode in chip_smoke.WANT_LAUNCHES}
    rows = chip_smoke.phase_timing(torch.device("cuda", 0), {}, {},
                                   collections.defaultdict(int))
    buckets = bucket_times(chip_smoke, torch.device("cuda", 0))
    result = dict(src=str(src), card=smi, forwards=forwards, kernels=rows,
                  buckets=buckets)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
