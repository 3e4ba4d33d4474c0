"""Build and bind the port's CUDA kernels (faucet_tpu_torch/csrc/*.cu).

At first use, nvcc compiles the sources for Hopper (sm_90a), one nvcc
process per source, all started together, and links the objects into one
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

import torch

from faucet_tpu_torch import metrics as M

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("probe.cu", "cascade.cu", "bloom_scatter.cu", "compact.cu",
           "wide_ext.cu", "table_upsert.cu")
HEADERS = ("bloom_bits.cuh", "hash.cuh")
BLOCK_BITS = 9  # 512-bit filter blocks (csrc/bloom_bits.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                               "-o", str(o), str(CSRC / s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs, failed = [], []
    for s, p in zip(SOURCES, procs):
        logs.append(f"== {s}\n{p.communicate()[0]}")
        if p.returncode:
            failed.append(s)
    if not failed:
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        logs.append(f"== link\n{r.stdout}{r.stderr}")
        if r.returncode:
            failed.append("link")
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{build_log}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.ft_bloom_contains.restype = i32
        lib.ft_bloom_contains.argtypes = [p, i64, p, p, p, i64, p, i64, i32,
                                          i32, i32, p]
        lib.ft_cascade_insert.restype = i32
        lib.ft_cascade_insert.argtypes = [p, i64, p, i64, p, p, p, i64, i32,
                                          i32, i32, i32, i32, p, i64, p, p,
                                          p, p]
        lib.ft_bloom_insert_codes.restype = i32
        lib.ft_bloom_insert_codes.argtypes = [p, i64, p, p, p, i64, i32,
                                              i32, i32, p]
        lib.ft_scatter_or_bits.restype = i32
        lib.ft_scatter_or_bits.argtypes = [p, i64, p, i64, p]
        lib.ft_mask_indices.restype = i32
        lib.ft_mask_indices.argtypes = [p, i64, p, i64, p, p, i64, i32, p]
        lib.ft_wide_ext_keys.restype = i32
        lib.ft_wide_ext_keys.argtypes = [p, p, i64, i32, p, p, p]
        i64s = ctypes.POINTER(i64)
        lib.ft_table_upsert.restype = i32
        lib.ft_table_upsert.argtypes = [p, p, i64, p, p, p, p, p, i64, i64,
                                        p, p, p, p, p, p, p, p, i32, i32,
                                        i64s, i32, i64s, p]
        lib.ft_table_upsert_threads.restype = i64
        lib.ft_table_upsert_threads.argtypes = []
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
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- the one boundary of every kernel entry -------------------------------
#
# An entry (kernels/probe.py, cascade.py, bloom_scatter.py, compact.py,
# wide_ext.py, upsert.py) checks what both of its versions need, on both
# devices (`filter_bits`, `lanes` and its own ranges), then takes its
# plain torch version for CPU tensors, or for CUDA tensors checks what
# only the card needs (`on_card`) and makes ONE `launch`, which counts
# itself in the tally as `<kernel>_launches`. Nothing falls back from one
# version to the other.


def filter_bits(name: str, words, log2_bits: int, shard_bits: int,
                n_hash: int) -> int:
    """Check a blocked filter of 2**log2_bits bits: int32 words, as many
    as its bits fill, local block-index bits in [0, 32) once shard_bits
    are taken, and n_hash in [1, 16]. Returns the local block bits."""
    if words.dtype != torch.int32 or words.shape != (1 << (log2_bits - 5),):
        raise ValueError(f"{name}: not an int32 filter of 2**{log2_bits} "
                         f"bits: {words.dtype} {tuple(words.shape)}")
    block_bits = log2_bits - shard_bits - BLOCK_BITS
    if not 0 <= block_bits < 32:
        raise ValueError(f"{name}: 2**{log2_bits} bits with shard_bits "
                         f"{shard_bits}")
    if not 1 <= n_hash <= 16:
        raise ValueError(f"{name}: n_hash out of range: {n_hash}")
    return block_bits


def lanes(like, *named):
    """Check each (name, tensor, dtype) of `named`: its dtype, and like's
    shape and device (`like` may be one of them)."""
    shape, dev = like.shape, like.device
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if t is not like and (t.shape != shape or t.device != dev):
            raise ValueError(f"{name}: expected {tuple(shape)} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")


def on_card(*named, filters=()):
    """The card's own check before a launch: each (name, tensor) of
    `filters` and `named` contiguous on one CUDA device, and each filter's
    words 16-byte aligned (its kernel reads a block as four uint4)."""
    named = filters + named
    first, t0 = named[0]
    dev = t0.get_device()  # -1 off the card
    if dev < 0:
        raise ValueError(f"{first}: expected a CUDA tensor, got {t0.device}")
    for name, t in named:
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on cuda:{dev}")
    for name, t in filters:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")


def launch(fn: str, count, *args, on_fail=None):
    """One launch: library().ft_<fn>(*args). A non-zero return raises
    (after on_fail(), which drops scratch a failed launch may leave
    dirty); a launch is counted in the tally under `count`, a key or a
    tuple of keys (`<kernel>_launches`)."""
    code = getattr(library(), "ft_" + fn)(*args)
    if code:
        if on_fail is not None:
            on_fail()
        check(code, fn)
    if isinstance(count, str):
        M.count(count)
    else:
        for key in count:
            M.count(key)
