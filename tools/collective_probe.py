#!/usr/bin/env python3
"""What one collective costs when ranks share a card, on the card.

Spawns 4 ranks, then 2, on ``cuda:0`` (``launch.mesh.spawn``: gloo, every
collective on a CUDA tensor staged through pinned host memory) on a
``(1, n)`` mesh and times, on each rank, the operations the sharded LM
path is made of:

- a small kernel and a host read (the cost of a synchronize when the
  ranks' contexts share the card);
- a small device-to-pinned copy;
- ``psum`` of a (2, 4096) float32 tensor, on the card and on the CPU (the
  gloo round trip alone);
- ``all_gather`` of one decode token's q/k/v, (2, 1, 12, 128) bf16;
- ``psum`` of a (2, 2048, 4096) float32 tensor (64 MB: a minitron-8b
  prefill's row-parallel sum), on the card and on the CPU;
- ``all_to_all`` of a (40, 1024, 1536) bf16 bucket (granite-moe's
  prefill exchange at capacity factor 5).

Each is warmed up once and then timed over a number of calls between
synchronizes; it prints ms a call on every rank, and the card's name and
power limit.  Run from the repository root on a machine with a card:

    python3 tools/collective_probe.py
"""

import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.distributed.sharding import rules_for_mesh  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402


def timed(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def rank(r, dev, world):
    mesh = mesh_lib.make_host_mesh(data=1, model=world, device=dev)
    m = rules_for_mesh(mesh).comm("model")
    small = torch.randn(2, 4096, device=dev)
    small_cpu = small.cpu()
    qkv = torch.randn(2, 1, 12, 128, device=dev).bfloat16()
    big = torch.randn(2, 2048, 4096, device=dev)
    big_cpu = big.cpu()
    bucket = torch.randn(40, 1024, 1536, device=dev).bfloat16()
    out = {}
    for name, fn, n in [
            ("kernel + host read", lambda: (small * 2).sum().item(), 200),
            ("small copy to pinned", lambda: torch.empty(
                small.shape, pin_memory=True).copy_(small), 200),
            ("psum (2, 4096) f32, card", lambda: m.psum(small), 200),
            ("psum (2, 4096) f32, CPU", lambda: m.psum(small_cpu), 200),
            ("all_gather q/k/v bf16, card", lambda: m.all_gather(qkv, 1),
             200),
            ("psum 64 MB f32, card", lambda: m.psum(big), 5),
            ("psum 64 MB f32, CPU", lambda: m.psum(big_cpu), 5),
            ("all_to_all 126 MB bf16, card",
             lambda: m.all_to_all(bucket, 0, 1), 5)]:
        fn()
        m.psum(torch.zeros(1))
        out[name] = timed(fn, n)
    return mesh.describe(), out


def main() -> int:
    if not torch.cuda.is_available():
        print("collective_probe: no CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    for world in (4, 2):
        res = mesh_lib.spawn(rank, world, world, device="cuda",
                             timeout_s=300)
        print(f"{world} ranks: {res[0][0]}")
        for k in res[0][1]:
            print(f"  {k}: " + ", ".join(f"{r[1][k]:.3f}" for r in res)
                  + f" ms ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
