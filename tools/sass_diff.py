#!/usr/bin/env python3
"""Compare the SASS of K7's and K7b's kernels between two built kernel
libraries, instantiation by instantiation.

Each tree's ``build/libphonebit_*.so`` (built by ``tools/k7b_probe.py``
or any first kernel call) is disassembled with ``cuobjdump -sass``; a
kernel of one tree is paired with the same head width of the other, the
unpadded instantiation where the other has a padded one too
(``<128>`` with ``<128, false>``).  Addresses and encodings are stripped,
and the instructions that differ in place are printed.  Needs the CUDA
toolkit (``cuobjdump``), not a card:

    python3 tools/sass_diff.py PARENT_TREE/build CHANGE_TREE/build
"""

from __future__ import annotations

import argparse
import glob
import re
import shutil
import subprocess

KERNELS = ("flash_fwd_kernel", "flash_bwd_main_kernel",
           "flash_bwd_dot_kernel")


def cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def kernels(build_dir: str) -> dict[tuple[str, int, bool], list[str]]:
    """(kernel, HD, padded) -> its instructions, for one library."""
    (lib,) = glob.glob(f"{build_dir}/libphonebit_*.so")
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        kernel = next((k for k in KERNELS if k in name), None)
        if kernel is None:
            continue
        width = re.search(r"ILi(\d+)E(Lb(\d)E)?", name)
        out[(kernel, int(width.group(1)), width.group(3) == "1")] = [
            m.group(1) for m in (
                re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\*", line)
                for line in body.splitlines()) if m]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the first tree's build/ directory")
    ap.add_argument("change", help="the second tree's build/ directory")
    args = ap.parse_args()
    a, b = kernels(args.parent), kernels(args.change)
    print("first:", sorted(a), "\nsecond:", sorted(b))
    for key in sorted(a):
        x, y = a[key], b.get(key, [])
        diff = [(i, j) for i, j in zip(x, y) if i != j]
        print(f"{key[0]}<{key[1]}{', true' if key[2] else ''}>: "
              f"{len(x)} against {len(y)} instructions, "
              f"{len(diff)} differ in place: {diff[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
