#!/usr/bin/env python3
"""A short first check of K7 with its lse and of K7b on the card.

Builds the kernel library, then at six shapes (lm-100m's layer, a
minitron-8b layer at S 512 and ragged, non-causal and G = 1 cases) holds
K7's output with the lse equal to its serving output, the lse against the
plain version's, and K7b's dq, dk, dv against its plain version within
2e-2·(1 + |plain|) and against autograd of the float32
``reference_attention``; prints each backward's and forward's time a call
(CUDA events around 20 calls) and the card's name and power limit.  Exits
non-zero on a mismatch.  Needs one CUDA card:

    python3 tools/k7b_probe.py
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402
from repro_torch.models.layers import reference_attention  # noqa: E402

TOL = 2e-2
# (name, B, Sq, Skv, H, KV, hd, causal)
CASES = [("lm-100m layer", 8, 512, 512, 12, 4, 64, True),
         ("minitron layer S512", 2, 512, 512, 32, 8, 128, True),
         ("hd64 ragged S100", 1, 100, 100, 12, 4, 64, True),
         ("hd128 ragged S129 noncausal", 1, 129, 129, 8, 8, 128, False),
         ("hd64 Sq100 Skv300 noncausal", 1, 100, 300, 12, 4, 64, False),
         ("hd128 S 200 causal G1", 2, 200, 200, 4, 4, 128, True)]


def ms_a_call(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("k7b_probe: no CUDA device")
        return 1
    path, secs = build.build(verbose=True)
    print("built", path.name, secs, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for name, b, sq, skv, h, kvh, hd, causal in CASES:
        q, k, v, do = (torch.randn(shape, device=dev, generator=g).bfloat16()
                       for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                                     (b, skv, kvh, hd), (b, sq, h, hd)))
        served = k7.flash_attention(q, k, v, causal)
        out, lse = k7.flash_attention_fwd(q, k, v, causal)
        _, plain_lse = k7.flash_attention_plain(q, k, v, causal,
                                                return_lse=True)
        same = torch.equal(out, served)
        lse_err = (lse - plain_lse).abs().max().item()
        grads = k7.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        plain = k7.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
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
        rel = [(a.float() - r).abs().max().item() / (1 + r.abs().max().item())
               for a, r in zip(grads, ref)]
        if not same or lse_err > 1e-3:
            bad += 1
        print(f"{name}: out with lse == without: {same}; lse err "
              f"{lse_err:.3e}; bwd vs plain "
              f"{[f'{e:.3e}' for e in errs]}; vs f32 autograd (rel) "
              f"{[f'{e:.3e}' for e in rel]}", flush=True)
        bwd = ms_a_call(lambda: k7.flash_attention_bwd(q, k, v, out, lse, do,
                                                       causal))
        fwd = ms_a_call(lambda: k7.flash_attention(q, k, v, causal))
        print(f"   bwd {bwd:.4f} ms, fwd {fwd:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("mismatches", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
