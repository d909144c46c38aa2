#!/usr/bin/env python3
"""Every variant of the +-1 mainloop (K6, and K2 without word weights) at
the serving shapes, timed on the card beside ``plan_pm1``'s pick.

The variants are the tiles and ring depths that were tried for the
mainloop (``VARIANTS``: the three tiles of ``pm1_gemm.TILES`` and eight
more, at 3 and 4 stages; 3 for the ``wgmma`` tiles), each at every
cluster split (a power of two up to 8, no empty slice).  They are built
from ``tools/pm1_variants.cu``, which instantiates the whole table with
the served epilogues, into ``build/`` beside the kernel library.

For each shape — K6 at AlexNet's conv2-fc7 (``cuda_pm1``, batch 8), K2 at
fc6/fc7 and conv2's im2col rows (``cuda_popcount``), K6 at fc6/fc7 for
the smaller buckets (batch 1, 2, 4), and K6 at conv2-conv5 for those
buckets on the planner's tile alone (every split: what splitting an
unfilled grid would give) — each variant is launched, checked bit for bit
against the kernel's plain version, and timed by torch.profiler's device
time over 20 calls (``chip_smoke.device_ms``).  Prints one line a plan
and, a shape, the planner's pick beside the fastest; writes the rows as
JSON.  Needs one CUDA card (~3 min with the builds).

    python3 tools/pm1_sweep.py [--out chiprun_out/pm1_sweep.json]
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import build, pm1_gemm  # noqa: E402

VARIANTS_SRC = ROOT / "tools" / "pm1_variants.cu"
_T = pm1_gemm.Tile
# pm1_variants.cu's numbering.  8 and 9 differ only in when the wgmma
# tile expands its next bytes (during or after the products).
VARIANTS = (_T(False, 2, 4, 2, 2, 8),      # 64 x 64, 8 words a stage
            _T(True, 1, 1, 4, 1, 16),      # 64 filters x 8 batch rows
            _T(True, 1, 2, 4, 1, 16),      # 64 filters x 16 batch rows
            _T(False, 2, 4, 2, 2, 16),     # 64 x 64, 16 words a stage
            _T(True, 1, 1, 2, 1, 16),      # 32 filters x 8 batch rows
            _T(True, 1, 1, 4, 1, 32),      # 64 x 8, 32 words a stage
            _T(False, 1, 4, 2, 2, 8),      # 32 x 64
            _T(False, 1, 4, 4, 2, 8),      # 64 x 64, 8 warps
            _T(False, 1, 16, 4, 1, 8, wgmma=True),   # 64 x 128, wgmma
            _T(False, 1, 16, 4, 1, 8, wgmma=True),   # the same, no overlap
            _T(False, 1, 8, 4, 1, 8, wgmma=True))    # 64 x 64, wgmma
Variant = collections.namedtuple("Variant", "variant stages cluster")


def served(plan: pm1_gemm.Plan) -> Variant:
    """The variant that runs ``plan`` (the library's tile at its ring
    depth)."""
    return Variant(VARIANTS.index(pm1_gemm.TILES[plan.tile]),
                   pm1_gemm.STAGES, plan.cluster)


def variants_library() -> ctypes.CDLL:
    """``tools/pm1_variants.cu`` built into ``build/`` (once a hash of it
    and the kernel sources) and loaded."""
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for src in [VARIANTS_SRC, *build.sources(),
                *sorted(build.CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = build.BUILD_DIR / f"libpm1_variants_{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-shared", str(VARIANTS_SRC), "-o",
                        str(tmp)], check=True)
        os.replace(tmp, out)
        print(f"[pm1_sweep] built {out.name} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.variant_mxu_pm1_matmul.argtypes = [p, p, p] + [i] * 7 + [p]
    lib.variant_fused_matmul_bn_binarize.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.variant_error_string.argtypes = [i]
    lib.variant_error_string.restype = ctypes.c_char_p
    return lib


def shapes():
    """(kernel, name, M, N, W, every variant) of every timed call; the
    last is False where only the planner's tile is timed."""
    out = []
    for name, (n, h, w, c), k, st, pad, o, _ in cs.ALEXNET_MATMULS[1:]:
        oh, ow = (cs.conv_out_size(d, k, st, pad) for d in (h, w))
        out.append(("K6", name, n * oh * ow, o,
                    k * k * packing.num_words(c), True))
    out += [("K2", "fc6", 8, 4096, 288, True),
            ("K2", "fc7", 8, 4096, 128, True),
            ("K2", "conv2 im2col", 5832, 256, 75, True)]
    for m in (1, 2, 4):
        out += [("K6", f"{fc} batch {m}", m, 4096, w, True)
                for fc, w in (("fc6", 288), ("fc7", 128))]
    for batch in (1, 2, 4):
        out += [(kernel, f"{name} batch {batch}", m * batch // cs.BATCH, n,
                 w, False)
                for kernel, name, m, n, w, _ in out[:4]]
    return out


def plans(m: int, w: int, every: bool, pick: Variant):
    units = w // pm1_gemm.granule(w)
    for v, t in enumerate(VARIANTS):
        if t.swap and m > t.by or not every and v != pick.variant:
            continue
        for stages in (3,) if t.wgmma else (3, 4):
            if not every and stages != pick.stages:
                continue
            for cluster in (1, 2, 4, 8):
                if cluster <= units:
                    yield Variant(v, stages, cluster)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "pm1_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pm1_sweep: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    lib = variants_library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[pm1_sweep] {smi}", flush=True)
    inp = cs.Inputs(dev, seed=4)
    stream = build.stream_ptr(dev)

    def check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err} at launch: "
                               f"{lib.variant_error_string(err).decode()}")

    rows = []
    for kernel, name, m, n, w, every in shapes():
        a, b = inp.words(m, w), inp.words(n, w)
        if kernel == "K6":
            want = cs.k6.mxu_pm1_matmul_plain(a, b, 32 * w)
            out = torch.empty((m, n), dtype=torch.int32, device=dev)

            def call(p):
                check(lib.variant_mxu_pm1_matmul(
                    a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, w, 0,
                    *p, stream), name)
        else:
            thr, sgn = inp.epilogue(n, torch.ones(w, device=dev),
                                    torch.full((w,), 32, device=dev))
            want = cs.k2.fused_matmul_bn_binarize_plain(a, b, thr, sgn)
            out = torch.empty_like(want)

            def call(p):
                check(lib.variant_fused_matmul_bn_binarize(
                    a.data_ptr(), b.data_ptr(), thr.data_ptr(),
                    sgn.data_ptr(), out.data_ptr(), m, n, w, *p, stream),
                    name)
        pick = served(pm1_gemm.plan_pm1(m, n, w, build.sm_count(dev)))
        times = {}
        for p in plans(m, w, every, pick):
            out.fill_(-1)
            call(p)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"[pm1_sweep] {kernel} {name} {p}: "
                                     f"kernel != plain")
            try:
                times[p] = cs.device_ms(lambda: call(p))
            except RuntimeError as e:       # the profiler saw nothing
                print(f"[pm1_sweep] {kernel} {name} {p}: {e}")
                continue
            print(f"[pm1_sweep] {kernel} {name} ({m}, {n}, {w}) variant "
                  f"{p.variant} stages {p.stages} cluster {p.cluster}: "
                  f"{times[p] * 1e3:.2f} us, exact"
                  + ("  <- plan_pm1" if p == pick else ""), flush=True)
        best = min(times, key=times.get)
        if pick not in times:
            times[pick] = cs.device_ms(lambda: call(pick))
        print(f"[pm1_sweep] {kernel} {name}: plan_pm1 {pick} "
              f"{times[pick] * 1e3:.2f} us, fastest {best} "
              f"{times[best] * 1e3:.2f} us ({times[pick] / times[best]:.3f}x)",
              flush=True)
        rows.append(dict(kernel=kernel, name=name, m=m, n=n, w=w,
                         pick=pick._asdict(), best=best._asdict(),
                         times=[dict(p._asdict(), device_ms=t)
                                for p, t in times.items()]))
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
