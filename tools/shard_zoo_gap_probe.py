#!/usr/bin/env python3
"""Where the bf16 gap of ``chip_smoke.py``'s ``[shard zoo]`` step 0 comes
from: ViT-H/14's and DiT-XL/2's gathered gradient leaves against one
device's, on the phase's train cell (B 8 at 224² / 256²), on three meshes
of the same 4 ranks sharing one card:

* (2, 2), the phase's mesh: DP, FSDP and TP at once;
* (4, 1): the batch axes alone (FSDP gathers and reduce-scatters of the
  float32 leaves, the batch sums), no model axis;
* (1, 4): the model axis alone (row-parallel sums, the column-parallel
  inputs' cotangent sums, DiT's sequence-sharded residual), no FSDP.

Beside them, the one-device floor: the same gradient from two half
batches.  A mesh whose worst leaf sits at the floor adds no rounding of
its own; the mesh that carries the gap names the collectives that make
it.  Run on a machine with one card (~4 min with the machine's boot):

    python3 tools/shard_zoo_gap_probe.py
"""

import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

ARCHS = ("vit-h14", "dit-xl2")
MESHES = ((2, 2), (4, 1), (1, 4))


def gap_rank(rank, device, jobs):
    """Step 0's bf16 gathered leaves on each mesh, against one device."""
    out = {}
    for job in jobs:
        arch, cfg = job["arch"], job["cfg"]
        mod = chip_smoke._zoo_module(arch)
        for dp, tp in MESHES:
            rules = sharding.rules_for_mesh(mesh_lib.make_host_mesh(
                data=dp, model=tp, device=device))
            pspecs = mod.param_specs(cfg, rules)
            params = sharding.shard_tree(job["params"], pspecs, rules)
            pipe = chip_smoke._zoo_pipe(arch, cfg, job["batch"], job["res"],
                                        device)
            b0 = chip_smoke._zoo_rows(arch, pipe.batch_at(0), rules)
            loss, grads = chip_smoke._zoo_vg(arch, cfg, params, None, b0,
                                             rules)
            grads = sharding.sync_grads(grads, pspecs, rules)
            errs = chip_smoke._zoo_leaf_errs(
                grads, job["grads_bf16"], pspecs, rules,
                chip_smoke.SHARD_ZOO_FLOOR)
            out[arch, dp, tp] = dict(loss=loss, worst=sorted(errs)[-3:])
            del params, grads
            torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("shard_zoo_gap_probe: no CUDA device")
        return 1
    device = torch.device("cuda", 0)
    smi = chip_smoke.phase_build()
    t0 = time.perf_counter()
    jobs, singles = [], {}
    for arch in ARCHS:
        job, singles[arch] = chip_smoke.shard_zoo_job(arch, device)
        job.pop("grads_f32", None)
        jobs.append(job)
    ranks = mesh_lib.spawn(gap_rank, chip_smoke.SHARD_RANKS, jobs,
                           device="cuda",
                           timeout_s=chip_smoke.SHARD_TIMEOUT_S)
    for arch in ARCHS:
        single = singles[arch]
        print(f"[gap] {arch}: one-device loss {single['loss']:.6f}; floor "
              f"from two half batches: worst leaf {max(single['floor']):.3e}"
              f" ({smi})")
        for dp, tp in MESHES:
            r = ranks[0][arch, dp, tp]
            worst = ", ".join(f"{p} {e:.3e}" for e, p in reversed(
                r["worst"]))
            print(f"[gap] {arch} on (data {dp}, model {tp}): loss "
                  f"{r['loss']:.6f} (gap {abs(r['loss'] - single['loss']) / abs(single['loss']):.3e}); "
                  f"worst gathered leaves {worst}")
    print(f"[gap] took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
