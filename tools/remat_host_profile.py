#!/usr/bin/env python3
"""Where a train step's wall time goes with per-layer remat, on the card.

For lm-100m (B 8 x S 512, ``launch/train.py``'s ``LM_100M``) and DiT-XL/2
(train_256's latents at batch 32), it runs the model's train step under
each of ``VARIANTS``: no remat (``layers.scan_layers`` patched to
``remat=False``), remat under the config's policy, the other policy, and
each with ``torch.utils.checkpoint.checkpoint``'s ``preserve_rng_state``
on and off.  For each it prints

- wall ms a step: steps closed by a synchronize, the variants taken in
  turn ``--rounds`` times (``STEPS`` steps each, the first dropped), the
  median;
- one step under torch.profiler: device ms and kernels, and the host's
  aten ops and their self CPU ms;
- one step under cProfile: the host seconds spent in each Python file's
  own code (``tottime``), for the files of ``torch.utils.checkpoint``,
  the dispatch modes, autograd's hooks and the RNG state, and the largest
  functions.

Every variant's loss and gradient norm at the same step are printed too;
all variants of a model compute the same step.  Beside the card's name and
power limit.  Needs one CUDA card:

    python3 tools/remat_host_profile.py [--rounds 5] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import pathlib
import pstats
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STEPS = 4
DIT_BATCH = 32
# (name, remat, policy (None: the config's), preserve_rng_state)
VARIANTS = {
    "lm-100m": [("no remat", False, None, True),
                ("remat nothing, rng kept", True, None, True),
                ("remat nothing, rng not kept", True, None, False)],
    "dit-xl2": [("no remat", False, None, True),
                ("remat dots, rng kept", True, None, True),
                ("remat dots, rng not kept", True, None, False),
                ("remat nothing, rng kept", True, "nothing", True),
                ("remat nothing, rng not kept", True, "nothing", False)],
}
# Python files whose own time is the checkpoint's host cost.
REMAT_FILES = ("torch/utils/checkpoint.py", "torch/utils/_python_dispatch.py",
               "torch/autograd/graph.py", "torch/random.py",
               "torch/cuda/random.py", "torch/_ops.py")


@contextlib.contextmanager
def variant(layers, torch, remat: bool, policy, preserve: bool):
    """Train steps under one variant: ``layers.scan_layers`` with ``remat``
    and ``policy`` forced, ``checkpoint`` with ``preserve_rng_state``."""
    scan, ckpt = layers.scan_layers, torch.utils.checkpoint.checkpoint
    force = {"remat": remat} | ({"remat_policy": policy} if policy else {})
    layers.scan_layers = lambda *a, **kw: scan(*a, **{**kw, **force})
    torch.utils.checkpoint.checkpoint = lambda *a, **kw: ckpt(
        *a, **{**kw, "preserve_rng_state": preserve})
    try:
        yield
    finally:
        layers.scan_layers, torch.utils.checkpoint.checkpoint = scan, ckpt


def model(name: str, torch, device: str, smoke: bool):
    """(train step, state, batch, loss function, config) of one model;
    with ``smoke`` its SMOKE config at batch 2 (to try the tool)."""
    from repro_torch import configs, data, optim
    from repro_torch.launch import train
    from repro_torch.models import dit, transformer
    g = torch.Generator(device=device).manual_seed(0)
    if name == "lm-100m":
        cfg = configs.get("minitron-8b").smoke if smoke else train.LM_100M
        params = transformer.init_params(cfg, g, device, dtype=torch.float32)
        batch = data.TokenPipeline(seed=0, batch=2 if smoke else 8,
                                   seq_len=16 if smoke else 512,
                                   vocab=cfg.vocab,
                                   device=device).batch_at(0)
        return (transformer.make_train_step(cfg),
                [params, optim.adamw_init(params)], batch,
                transformer.loss_fn, cfg)
    cfg = configs.get("dit-xl2").smoke if smoke else \
        configs.get("dit-xl2").full
    params = dit.init_params(cfg, g, device, dtype=torch.float32)
    for leaves in (params, params["layers"]):
        for leaf in ("ada_w", "ada_b", "final_ada_w", "final_ada_b",
                     "final_w", "final_b"):
            if leaf in leaves:
                leaves[leaf].copy_(torch.randn(
                    leaves[leaf].shape, device=device, generator=g) * 0.02)
    batch = data.LatentPipeline(seed=0, batch=2 if smoke else DIT_BATCH,
                                latent_res=cfg.latent_res(),
                                n_classes=cfg.n_classes, device=device,
                                prefetch=0).batch_at(0)
    return (dit.make_train_step(cfg),
            [params, optim.adamw_init(params)], batch, dit.train_loss, cfg)


def sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def step_ms(torch, run) -> float:
    t0 = time.perf_counter()
    run()
    sync(torch)
    return (time.perf_counter() - t0) * 1e3


def profile_step(torch, run) -> dict:
    """Device ms and kernels, host aten ops and their self CPU ms, of one
    step (after one untraced)."""
    from torch.profiler import ProfilerActivity, profile
    run()
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        sync(torch)
    dev_us = kernels = cpu_us = ops = 0
    by_op = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            dev_us += getattr(e, "self_device_time_total", 0) or 0
            kernels += e.count
        elif e.key.startswith("aten::"):
            ops += e.count
            cpu_us += e.self_cpu_time_total
            by_op[e.key] = (e.count, e.self_cpu_time_total / 1e3)
    return dict(device_ms=dev_us / 1e3, kernels=kernels, aten_ops=ops,
                aten_self_cpu_ms=cpu_us / 1e3, by_op=by_op)


def cprofile_step(torch, run) -> dict:
    """Host seconds of one step by Python file (own time) and the largest
    functions, under cProfile."""
    run()
    sync(torch)
    prof = cProfile.Profile()
    prof.enable()
    run()
    sync(torch)
    prof.disable()
    st = pstats.Stats(prof)
    by_file, funcs, total = {}, [], 0.0
    for (file, line, fn), (_, calls, tt, ct, _) in st.stats.items():
        total += tt
        key = next((f for f in REMAT_FILES if file.endswith(f)), None)
        if key:
            by_file[key] = by_file.get(key, 0.0) + tt * 1e3
        funcs.append((tt * 1e3, calls, f"{pathlib.Path(file).name}:{line} "
                                       f"{fn}"))
    funcs.sort(reverse=True)
    return dict(total_ms=total * 1e3, by_file=by_file, top=funcs[:12])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", help="write every number here as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="SMOKE configs on the CPU, to try the tool")
    args = ap.parse_args()
    import torch
    import torch.utils.checkpoint
    device = "cpu" if args.smoke else "cuda"
    if not args.smoke and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch import tree
    from repro_torch.models import layers
    smi = "the CPU (SMOKE configs)" if args.smoke else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out = {"card": smi}
    for name in VARIANTS:
        step, state, batch, loss_fn, cfg = model(name, torch, device,
                                                 args.smoke)
        vs = VARIANTS[name]

        def run(state=state, batch=batch, step=step):
            step(*state, batch)

        times = {v[0]: [] for v in vs}
        for _ in range(args.rounds):
            for v in vs:
                with variant(layers, torch, *v[1:]):
                    got = [step_ms(torch, run) for _ in range(STEPS)]
                times[v[0]] += got[1:]
        rows = {}
        for v in vs:
            with variant(layers, torch, *v[1:]):
                (loss, _), grads = tree.value_and_grad(
                    loss_fn, state[0], batch, cfg)
                gnorm = torch.sqrt(sum(g.float().square().sum()
                                       for g in tree.leaves(grads))).item()
                del grads
                prof = profile_step(torch, run)
                cprof = cprofile_step(torch, run)
            rows[v[0]] = dict(ms=statistics.median(times[v[0]]),
                              ms_all=times[v[0]], loss=loss.item(),
                              grad_norm=gnorm, **prof, cprofile=cprof)
        base = rows[vs[0][0]]
        for v in vs:
            r = rows[v[0]]
            print(f"[{name}] {v[0]}: {r['ms']:.3f} ms a step (median of "
                  f"{len(r['ms_all'])}: {min(r['ms_all']):.3f}-"
                  f"{max(r['ms_all']):.3f}); device {r['device_ms']:.3f} ms "
                  f"in {r['kernels']} kernels; host {r['aten_ops']} aten ops, "
                  f"{r['aten_self_cpu_ms']:.3f} ms of their self CPU; "
                  f"cProfile {r['cprofile']['total_ms']:.3f} ms of Python "
                  f"own time, of it "
                  + ", ".join(f"{f} {ms:.3f}" for f, ms in
                              sorted(r["cprofile"]["by_file"].items()))
                  + f"; loss {r['loss']:.6f}, grad norm "
                  f"{r['grad_norm']:.6f}", flush=True)
            if r is base:
                continue
            extra = sorted(((ms - base["by_op"].get(k, (0, 0.0))[1],
                             n - base["by_op"].get(k, (0, 0.0))[0], k)
                            for k, (n, ms) in r["by_op"].items()),
                           reverse=True)[:8]
            print(f"[{name}]   aten self CPU over no remat: "
                  + "; ".join(f"{k} +{ms:.3f} ms (+{n} calls)"
                              for ms, n, k in extra), flush=True)
            print(f"[{name}]   largest Python functions (own ms, calls): "
                  + "; ".join(f"{fn} {ms:.3f} ({c})"
                              for ms, c, fn in r["cprofile"]["top"][:8]),
                  flush=True)
        for r in rows.values():
            del r["by_op"]
        out[name] = rows
        del step, state, batch
        if not args.smoke:
            torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
