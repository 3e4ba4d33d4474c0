"""ctypes bindings for the C++ reader/packer (io/cpp/pack.cc).

Copied from faucet_tpu/io/native.py (the port imports nothing of
faucet_tpu); only where the shared object lands differs. It is built on
first use (g++ -O3; no pybind11) into faucet_tpu_torch/_build/, which git
ignores, under a name carrying a hash of the source, and moved into place
whole, so processes that build it at once never see a half-written file
and the checkout's tracked files never change. Falls back cleanly:
callers test `available()` and use the pure-Python reader otherwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Iterator, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cpp", "pack.cc")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")

_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libftpack_{tag}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
           "-o", tmp, "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[faucet_tpu] native packer build failed: {e}",
              file=sys.stderr)
        return False
    if r.returncode != 0:
        print(f"[faucet_tpu] native packer build failed:\n{r.stderr}",
              file=sys.stderr)
        return False
    os.replace(tmp, so)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _so_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        print(f"[faucet_tpu] native packer load failed: {e}",
              file=sys.stderr)
        return None
    lib.ft_open.restype = ctypes.c_void_p
    lib.ft_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ft_next_batch.restype = ctypes.c_int
    lib.ft_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int]
    lib.ft_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def native_batch_iter(path: str, fastq: bool, batch: int, max_len: int,
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (bases uint8[batch, max_len], lens int32[batch]) from the
    native parser. Each batch is a fresh numpy array, so the consumer may
    hold it while the next one is parsed."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native packer unavailable")
    h = lib.ft_open(path.encode(), 1 if fastq else 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            bases = np.empty((batch, max_len), dtype=np.uint8)
            lens = np.empty((batch,), dtype=np.int32)
            got = lib.ft_next_batch(
                h, bases.ctypes.data_as(ctypes.c_void_p),
                lens.ctypes.data_as(ctypes.c_void_p), batch, max_len)
            if got == 0:
                return
            yield bases, lens
            if got < batch:
                return
    finally:
        lib.ft_close(h)
