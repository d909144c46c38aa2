#!/usr/bin/env python3
"""A short check of K7 with its lse and of K7b on the card, and K7b's
times beside SDPA's backward with its backend pinned.

Builds the kernel library of the tree under ``--src`` (default: this
checkout), then at each of ``CASES`` holds K7's output with the lse equal
to its serving output, the lse against the plain version's, and K7b's dq,
dk, dv against its plain version within 2e-2·(1 + |plain|) and against
autograd of the float32 ``reference_attention``, and two K7b calls equal
bit for bit.  At the ``TIMED`` shapes (lm-100m's layer and minitron-8b's
prefill layer) it prints K7b's single-call time (median of CUDA-event
timings), each of its launches' device time (torch.profiler over 20
calls), its bound, K7's serving launch's device time, and SDPA's backward under every backend that takes
the shape (``torch.nn.attention.sdpa_kernel``; K/V expanded to H heads
where a backend takes no GQA, the expansion's backward counted), beside
the card's name and power limit.  Exits non-zero on a mismatch.  Needs
one CUDA card:

    python3 tools/k7b_probe.py [--src OTHER_TREE/src] [--out FILE.json]

Two trees (a parent and a change) are timed by one method when the probe
runs once for each in one call.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

TOL = 2e-2
# (name, B, Sq, Skv, H, KV, hd, causal)
LM100M = ("lm-100m layer", 8, 512, 512, 12, 4, 64, True)
MINITRON = ("minitron-8b prefill layer", 2, 2048, 2048, 32, 8, 128, True)
CASES = [LM100M, MINITRON,
         ("minitron layer S512", 2, 512, 512, 32, 8, 128, True),
         ("hd64 ragged S100", 1, 100, 100, 12, 4, 64, True),
         ("hd128 ragged S129 noncausal", 1, 129, 129, 8, 8, 128, False),
         ("hd64 Sq100 Skv300 noncausal", 1, 100, 300, 12, 4, 64, False),
         ("hd128 S 200 causal G1", 2, 200, 200, 4, 4, 128, True),
         ("hd64 S 640 G4", 1, 640, 640, 16, 4, 64, True)]
TIMED = [LM100M, MINITRON]
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
REPS = 20


def plain_blocks(sq: int, skv: int) -> tuple[int, int]:
    """Blocks of the plain versions: 512 cut to S, or 128 where 512 does not
    divide a longer S (the blocks must divide it)."""
    return tuple(512 if s <= 512 or s % 512 == 0 else 128 for s in (sq, skv))


def ms_a_call(torch, fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of one call after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(torch, fn, reps: int = REPS) -> dict[str, float]:
    """torch.profiler's device time a call of each kernel ``fn`` launches,
    over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type != torch.autograd.DeviceType.CPU:
            rows[e.key] = rows.get(e.key, 0.0) + us / reps / 1e3
    return rows


def sdpa_backwards(torch, q, k, v, do, causal):
    """(backend, expanded, grads, backward fn) for every SDPA backend that
    takes these bf16 (B, S, H, hd) tensors: the backward of one forward,
    repeated with ``retain_graph``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    out = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for expand in (False, True):
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2)
            try:
                with sdpa_kernel(backend):
                    if expand:
                        o = F.scaled_dot_product_attention(
                            qt, kt.repeat_interleave(g, 1),
                            vt.repeat_interleave(g, 1), is_causal=causal)
                    else:
                        o = F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, enable_gqa=True)

                    def bwd(o=o, leaves=(qt, kt, vt), dot=dot):
                        return torch.autograd.grad(o, leaves, dot,
                                                   retain_graph=True)
                    grads = [t.transpose(1, 2) for t in bwd()]
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"   SDPA {backend.name} "
                      f"{'expanded' if expand else 'gqa'}: refused "
                      f"({str(e).splitlines()[0][:100]})", flush=True)
                continue
            out.append((backend.name, expand, grads, bwd))
            break
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the tree to check and time")
    ap.add_argument("--out", help="write the timed rows here as JSON")
    args = ap.parse_args()
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.models.layers import reference_attention
    if not torch.cuda.is_available():
        print("k7b_probe: no CUDA device")
        return 1
    if not pathlib.Path(k7.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {k7.__file__}, not {src}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[k7b_probe] {src}: {smi}", flush=True)
    path, secs = build.build(verbose=True)
    print("built", path.name, secs, flush=True)
    if hasattr(k7, "kernel_info"):
        for hd in (64, 128):
            try:
                print(f"K7b at hd {hd}:", k7.kernel_info(hd, backward=True))
            except TypeError:                 # a tree before the redesign
                break
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    inputs = {}
    for name, b, sq, skv, h, kvh, hd, causal in CASES:
        q, k, v, do = (torch.randn(shape, device=dev, generator=g).bfloat16()
                       for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                                     (b, skv, kvh, hd), (b, sq, h, hd)))
        served = k7.flash_attention(q, k, v, causal)
        out, lse = k7.flash_attention_fwd(q, k, v, causal)
        blocks = plain_blocks(sq, skv)
        _, plain_lse = k7.flash_attention_plain(q, k, v, causal, *blocks,
                                                return_lse=True)
        same = torch.equal(out, served)
        lse_err = (lse - plain_lse).abs().max().item()
        grads = k7.flash_attention_bwd(q, k, v, out, lse, do, causal)
        again = k7.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, r) for a, r in zip(grads, again))
        plain = k7.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                             *blocks)
        errs = []
        for got, want in zip(grads, plain):
            got, want = got.float(), want.float()
            diff = (got - want).abs()
            errs.append(diff.max().item())
            if (diff > TOL * (1 + want.abs())).any() \
                    or not torch.isfinite(got).all():
                bad += 1
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(reference_attention(*leaves, causal=causal),
                                  leaves, do.float())
        rel = []
        for a, r in zip(grads, ref):
            rel.append(((a.float() - r).abs()
                        / (1 + r.abs())).max().item())
        if not same or lse_err > 1e-3 or not repeat or max(rel) > TOL:
            bad += 1
        print(f"{name}: out with lse == without: {same}; lse err "
              f"{lse_err:.3e}; bwd vs plain "
              f"{[f'{e:.3e}' for e in errs]}; vs f32 autograd "
              f"|diff| / (1 + |ref|) {[f'{e:.3e}' for e in rel]}; two calls "
              f"bit-equal: {repeat}", flush=True)
        inputs[name] = (q, k, v, do, out, lse, grads)
        del leaves, ref, plain, again

    rows = []
    for name, b, sq, skv, h, kvh, hd, causal in TIMED:
        q, k, v, do, out, lse, grads = inputs[name]

        def call(q=q, k=k, v=v, out=out, lse=lse, do=do, causal=causal):
            return k7.flash_attention_bwd(q, k, v, out, lse, do, causal)
        single = ms_a_call(torch, call)
        launches = device_ms_by_kernel(torch, call)
        nbytes = sum(t.numel() for t in (q, k, v, out, do, *grads)) * 2 \
            + lse.numel() * 4
        ops = 10.0 * b * h * hd * sq * (sq + 1) / 2 if causal \
            else 20.0 * b * h * hd * sq * skv / 2
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
            ops / BF16_FLOPS_PER_S * 1e3
        row = dict(shape=name, single_ms=single,
                   device_ms=sum(launches.values()), launches=launches,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   sdpa=[])
        print(f"[timing] K7b {name}: single {single:.4f} ms, device "
              f"{row['device_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
        for key, ms in sorted(launches.items(), key=lambda kv: -kv[1]):
            print(f"   {ms:.4f} ms  {key[:100]}", flush=True)
        row["k7_device_ms"] = sum(device_ms_by_kernel(
            torch, lambda: k7.flash_attention(q, k, v, causal)).values())
        print(f"   K7 (serving launch, no lse) device "
              f"{row['k7_device_ms']:.4f} ms", flush=True)
        for backend, expanded, sgrads, bwd in sdpa_backwards(torch, q, k, v,
                                                             do, causal):
            err = max(((a.float() - r.float()).abs()
                       / (1 + r.float().abs())).max().item()
                      for a, r in zip(grads, sgrads))
            s_single = ms_a_call(torch, bwd)
            s_dev = sum(device_ms_by_kernel(torch, bwd).values())
            row["sdpa"].append(dict(backend=backend, expanded=expanded,
                                    single_ms=s_single, device_ms=s_dev,
                                    err=err))
            print(f"   SDPA backward, backend {backend}"
                  f"{' (K/V expanded to H heads)' if expanded else ' (gqa)'}"
                  f": single {s_single:.4f} ms, device {s_dev:.4f} ms; "
                  f"K7b against it |diff| / (1 + |sdpa|) {err:.3e}",
                  flush=True)
            del sgrads, bwd
        rows.append(row)
        torch.cuda.empty_cache()
    print(smi)
    print("mismatches", bad)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            dict(src=str(src), card=smi, rows=rows, mismatches=bad),
            indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
