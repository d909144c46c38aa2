"""Build and load the port's CUDA kernel library.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together) and linked into one shared library with
a plain ``extern "C"`` interface, loaded with ``ctypes``.  No PyTorch
header is included, so a build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build would.

The library lands in ``build/`` at the repository root, named by a hash of
the sources and flags, and is built at first use: a fresh checkout builds
it on the first kernel launch, an unchanged one reuses it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# Launcher signatures: pointers and the stream as c_void_p (a plain int
# argument would be cut to 32 bits), sizes as c_int / c_longlong.
SIGNATURES = {
    "launch_bitplane_pack": (_P, _P, _LL, _I, _P),
    "launch_fused_matmul_bn_binarize": (_P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _P),
    "launch_fused_matmul_bn_binarize_pm1": (_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _P),
    "launch_direct_conv_bn_binarize": (_P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _I, _I, _P),
    "launch_direct_conv_mma": (_P, _P, _P, _P, _P, _P) + (_I,) * 20 + (_P,),
    "launch_chain_conv": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _P),
    "chain_conv_max_clusters": (_I, _I, _P),
    "chain_conv_info": (_P, _P),
    "launch_xnor_popcount_matmul": (_P, _P, _P, _P, _I, _I, _I, _P),
    "launch_xnor_popcount_mma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P),
    "launch_mxu_pm1_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "launch_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _P),
    "launch_flash_attention_bwd": (_P,) * 11 + (_I,) * 7 + (_F, _P),
    "flash_attention_bwd_workspace": (_I, _I, _I, _I, _P, _P),
    "flash_attention_info": (_I, _P, _P, _P),
    "flash_attention_bwd_info": (_I, _P, _P, _P, _P),
    "phonebit_smem_optin": (_I,),
}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libphonebit_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[pathlib.Path, float]:
    """Compile the library if it is not there yet; returns (path, seconds
    spent building — 0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc_bin = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        extra = ("-Xptxas", "-v") if verbose else ()
        objs, procs = [], []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc_bin, *NVCC_FLAGS, *extra, "-c", str(src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        if verbose:
            print("\n".join(logs))
        tmp_lib = pathlib.Path(tmp) / out.name
        subprocess.run([nvcc_bin, *NVCC_FLAGS, "-shared", *objs, "-o",
                        str(tmp_lib)], check=True, capture_output=True)
        os.replace(tmp_lib, out)   # atomic: concurrent builds agree
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, loaded once per
    process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.phonebit_error_string.argtypes = [ctypes.c_int]
    lib.phonebit_error_string.restype = ctypes.c_char_p
    return lib


def loads() -> int:
    """Kernel-library loads in this process (0 or 1): part of the engine's
    ``build_count``."""
    return library.cache_info().currsize


def check(err: int, name: str) -> None:
    """Raise when a launcher reports a CUDA error (a refused launch never
    runs, and a later synchronize would not say so)."""
    if err != 0:
        msg = library().phonebit_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Validate one kernel operand before its pointer is handed over."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: want {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (the tile planners' grid
    model)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream
