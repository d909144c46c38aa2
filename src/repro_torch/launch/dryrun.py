"""Multi-pod dry-run driver (counterpart of ``repro.launch.dryrun``).

Traces every (architecture × input shape) cell for the production meshes
— 16×16 single-pod and 2×16×16 two-pod — as one rank of a fake process
group of 256 or 512 ranks in this one process, and records FLOPs, bytes,
memory and each collective per cell (:mod:`repro_torch.launch.analysis`),
with the roofline terms of an NVIDIA H100 a rank.  The tensors are fakes
(``FakeTensorMode``): no card and no memory is needed, and no figure is a
time measured on a card.

Usage (``PYTHONPATH=src``):
    python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b --shape train_4k
    python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
    python -m repro_torch.launch.dryrun --all [--jobs 4] [--out artifacts/dryrun_torch]
    python -m repro_torch.launch.dryrun --report [--out artifacts/dryrun_torch]

``--device cuda`` (the default; needs PyTorch built for CUDA, not a card)
routes attention through K7's and K7b's fakes, as the card runs it;
``--device cpu`` through their plain versions, as the CPU tests do.
``--rank`` picks the rank traced (rank 0 by default).  ``--all`` fans
cells out to subprocesses, caches per-cell JSON, and prints the aggregate
table; ``--report`` re-prints the table from cached JSON.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def _cell_id(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    base = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
    return f"{base}__{tag}" if tag else base


def _parse_overrides(pairs):
    import ast
    out = {}
    for p in pairs or ():
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def run_one(arch: str, shape: str, multi_pod: bool, out_dir: str,
            overrides: dict | None = None, tag: str = "",
            device: str = "cuda", rank: int = 0) -> dict:
    """Trace one cell as rank ``rank`` in THIS process (inside a fake
    process group of its own, destroyed before it returns); returns the
    report dict.

    Cost-accounting protocol: the eager trace counts every op that runs,
    so one full-depth trace is exact and gives every figure.  For the LM,
    DiT and ViT cells the reference's two shallow probes (L=1, L=2) are
    traced too and :func:`~repro_torch.launch.analysis.extrapolate`'s
    figures printed beside the full trace's: a difference is a finding."""
    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch import analysis, cells
    from repro_torch.launch.mesh import (PRODUCTION_MESHES, fake_group,
                                         make_production_mesh)
    from repro_torch.models.dit import DiTConfig
    from repro_torch.models.transformer import LMConfig
    from repro_torch.models.vit import ViTConfig

    sizes = PRODUCTION_MESHES[multi_pod][0]
    world = 1
    for n in sizes:
        world *= n
    t0 = time.monotonic()
    with fake_group(world, rank):
        mesh = make_production_mesh(multi_pod=multi_pod, rank=rank,
                                    device=device)
        rules = rules_for_mesh(mesh)
        try:
            build = cells.build_cell(arch, shape, rules,
                                     overrides=overrides)
        except cells.SkippedCell as e:
            rep = dict(arch=arch, shape=shape, skipped=True, reason=str(e),
                       mesh="2x16x16" if multi_pod else "16x16")
            _save(out_dir, arch, shape, multi_pod, rep, tag)
            print(f"SKIP {arch} {shape}: {e}")
            return rep
        trace = build.trace()
        t_trace = time.monotonic() - t0
        full = analysis.collect(trace)
        probe = None
        if isinstance(build.cfg, (LMConfig, DiTConfig, ViTConfig)):
            probes = []
            for l in (1, 2):
                pb = cells.build_cell(arch, shape, rules,
                                      overrides=dict(overrides or {},
                                                     n_layers=l))
                probes.append(analysis.collect(
                    cells.trace_step(pb.step_fn, pb.abstract_args,
                                     rules.device, memory=False)))
            probe = analysis.extrapolate(probes[0], probes[1],
                                         build.cfg.n_layers)
    report = analysis.analyze(
        arch, shape, build.kind, mesh, trace,
        model_flops=analysis.model_flops_for(build), metrics=full,
        note=build.note)
    rep = report.to_json()
    rep.update(skipped=False, t_trace_s=round(t_trace, 1),
               t_total_s=round(time.monotonic() - t0, 1),
               overrides=overrides or {}, tag=tag, rank=rank,
               device=device, probe=probe)
    _save(out_dir, arch, shape, multi_pod, rep, tag)
    print(f"OK {arch} {shape} mesh={rep['mesh']} rank={rank} "
          f"bottleneck={rep['bottleneck']} "
          f"t=(c {rep['t_compute']:.4f}s, m {rep['t_memory']:.4f}s, "
          f"n {rep['t_collective']:.4f}s) "
          f"roofline={rep['roofline_fraction']:.3f} "
          f"peak={rep['peak_memory_bytes'] / 2**30:.2f} GiB "
          f"attention={rep['attention']} [trace {t_trace:.0f}s]")
    if probe is not None:
        diffs = {k: (full[k], probe[k]) for k in ("flops", "bytes", "wire")
                 if full[k] != probe[k]}
        if probe["counts"] != full["counts"]:
            diffs["counts"] = (full["counts"], probe["counts"])
        print(f"   probes L=1/L=2 extrapolated to L={build.cfg.n_layers}: "
              + ("equal to the full trace" if not diffs else
                 "differ from the full trace (full, extrapolated): "
                 + json.dumps(diffs)))
    return rep


def _save(out_dir, arch, shape, multi_pod, rep, tag: str = ""):
    p = pathlib.Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    (p / (_cell_id(arch, shape, multi_pod, tag) + ".json")).write_text(
        json.dumps(rep, indent=2))


def run_all(out_dir: str, jobs: int, multi_pod_also: bool = True,
            force: bool = False, timeout: int = 3600,
            device: str = "cuda", rank: int = 0) -> None:
    """Fan out every cell to subprocesses with caching."""
    from repro_torch import configs

    work = []
    for arch, shape in configs.all_cells():
        meshes = [False, True] if multi_pod_also else [False]
        for mp in meshes:
            cache = pathlib.Path(out_dir) / (
                _cell_id(arch, shape.name, mp) + ".json")
            if cache.exists() and not force:
                continue
            work.append((arch, shape.name, mp))

    def launch(item):
        arch, shape, mp = item
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out_dir,
               "--device", device, "--rank", str(rank)]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.monotonic()
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        dt = time.monotonic() - t0
        tag = _cell_id(arch, shape, mp)
        if r.returncode != 0:
            err = (r.stderr or r.stdout).strip().splitlines()
            _save(out_dir, arch, shape, mp,
                  dict(arch=arch, shape=shape, skipped=False, failed=True,
                       mesh="2x16x16" if mp else "16x16",
                       error="\n".join(err[-15:])))
            return f"FAIL {tag} ({dt:.0f}s)"
        probe = [ln for ln in r.stdout.splitlines() if "probes L=1" in ln]
        return f"done {tag} ({dt:.0f}s)" + (f"\n{probe[0]}" if probe else "")

    print(f"{len(work)} cells to trace, {jobs} parallel jobs")
    with ThreadPoolExecutor(max_workers=jobs) as ex:
        for msg in ex.map(launch, work):
            print(msg, flush=True)
    print_table(out_dir)


def print_table(out_dir: str) -> None:
    rows = []
    for f in sorted(pathlib.Path(out_dir).glob("*.json")):
        rows.append(json.loads(f.read_text()))
    if not rows:
        print("no cached reports in", out_dir)
        return
    hdr = (f"{'arch':24} {'shape':12} {'mesh':8} {'kind':8} "
           f"{'bottleneck':10} {'t_comp':>9} {'t_mem':>9} {'t_coll':>9} "
           f"{'roofline':>8} {'useful':>7} {'peakGB':>7}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if r.get("skipped"):
            print(f"{r['arch']:24} {r['shape']:12} {r.get('mesh', ''):8} "
                  f"SKIP     ({r.get('reason', '')[:60]})")
            continue
        if r.get("failed"):
            print(f"{r['arch']:24} {r['shape']:12} {r.get('mesh', ''):8} "
                  f"FAILED   {r.get('error', '').splitlines()[-1][:70]}")
            continue
        print(f"{r['arch']:24} {r['shape']:12} {r['mesh']:8} "
              f"{r['kind']:8} {r['bottleneck']:10} "
              f"{r['t_compute']:9.4f} {r['t_memory']:9.4f} "
              f"{r['t_collective']:9.4f} {r['roofline_fraction']:8.3f} "
              f"{r['useful_flops_ratio']:7.3f} "
              f"{r['peak_memory_bytes'] / 2**30:7.2f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="KEY=VALUE",
                    help="config override (hillclimb variants), repeatable")
    ap.add_argument("--tag", default="",
                    help="suffix for the report file (variants don't "
                         "clobber the baseline)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fake tensors claim to live: cuda "
                         "routes attention through K7/K7b's fakes, cpu "
                         "through their plain versions")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh traced")
    args = ap.parse_args()

    if args.report:
        print_table(args.out)
    elif args.all:
        run_all(args.out, args.jobs,
                multi_pod_also=not args.single_pod_only, force=args.force,
                device=args.device, rank=args.rank)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all/--report)")
        run_one(args.arch, args.shape, args.multi_pod, args.out,
                overrides=_parse_overrides(args.overrides), tag=args.tag,
                device=args.device, rank=args.rank)


if __name__ == "__main__":
    main()
