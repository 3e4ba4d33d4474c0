"""Build and bind the port's CUDA kernels (faucet_tpu_torch/csrc/*.cu).

At first use, nvcc compiles the sources for Hopper (sm_90a) into one
shared library with a plain C interface, which ctypes loads. The library
lands in faucet_tpu_torch/_build/ (git-ignored) under a name carrying a
hash of the sources and flags, so an edit to any source rebuilds it and
an unchanged tree reuses it. Nothing here runs at import time: the CPU
test suite imports every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("probe.cu", "cascade.cu")
HEADERS = ("bloom_bits.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# set by the build that produced the loaded library (None when it was
# already on disk): seconds, and nvcc's output (ptxas register counts)
build_seconds = None
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of faucet_tpu_torch are built from source")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfaucet_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    global build_seconds, build_log
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.ft_bloom_probe.restype = i32
        lib.ft_bloom_probe.argtypes = [p, i64, p, p, p, p, i64, i32, p]
        lib.ft_cascade_apply.restype = i32
        lib.ft_cascade_apply.argtypes = [p, i64, p, i64, p, p, p, p, p, p,
                                         p, p, p, p, i64, i32, i32, p]
        lib.ft_error_string.restype = ctypes.c_char_p
        lib.ft_error_string.argtypes = [i32]
        _lib = lib
    return _lib


def check(code: int, what: str):
    """Raise if a launcher returned a non-zero cudaGetLastError()."""
    if code:
        msg = library().ft_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: cuda error {code} "
                           f"({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t, dtype, ndim: int = 1):
    """Wrapper argument check: CUDA device, dtype, contiguity, rank."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {t.dim()}-D")
