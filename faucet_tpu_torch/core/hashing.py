"""32-bit hashing for k-mer codes, in torch
(port of faucet_tpu/core/hashing.py).

murmur3's 32-bit finalizer (`fmix32`) chained over the two words of a
code gives two independent hashes (h1, h2); h2 is forced odd. Bit-identical
to the reference: values are uint32 held in int64 (core/u32x2.py), and a
product is masked to its low 32 bits, which int64 wrap-around keeps exact.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_SEED1 = 0x9E3779B9
_SEED2 = 0x85EBCA77


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on uint32-valued int64."""
    x = x ^ (x >> 16)
    x = (x * _C1) & M32
    x = x ^ (x >> 13)
    x = (x * _C2) & M32
    return x ^ (x >> 16)


def hash_pair(hi, lo):
    """(hi, lo) k-mer code -> (h1, h2); h2 is odd.

    Both fmix32 chains run on one stacked tensor: half the launches of
    four separate calls, which matters in the walk's per-step loop."""
    x = fmix32(torch.stack([hi ^ _SEED1, lo ^ _SEED2]))
    y = fmix32(torch.stack([lo, hi]) ^ x)
    return y[0], y[1] | 1


def pair_key(ahi, alo, bhi, blo):
    """Order-independent 64-bit key for a junction pair."""
    swap = (bhi < ahi) | ((bhi == ahi) & (blo < alo))
    xhi = torch.where(swap, bhi, ahi)
    xlo = torch.where(swap, blo, alo)
    yhi = torch.where(swap, ahi, bhi)
    ylo = torch.where(swap, alo, blo)
    h1x, h2x = hash_pair(xhi, xlo)
    h1y, h2y = hash_pair(yhi, ylo)
    khi = fmix32((h1x + 3 * h1y) & M32)
    klo = fmix32(h2x ^ ((h2y * 5) & M32))
    # keep khi out of the table's EMPTY sentinel range
    return khi & 0x3FFFFFFF, klo


# ---- host numpy mirrors (copied from faucet_tpu/core/hashing.py) -------

def fmix32_np(x: np.ndarray) -> np.ndarray:
    """Host numpy mirror of fmix32 (bit-identical)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def hash_pair_np(hi, lo):
    """Host numpy mirror of hash_pair (bit-identical)."""
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    h1 = fmix32_np(lo ^ fmix32_np(hi ^ np.uint32(0x9E3779B9)))
    h2 = fmix32_np(hi ^ fmix32_np(lo ^ np.uint32(0x85EBCA77))) | np.uint32(1)
    return h1, h2


def pair_key_np(ahi, alo, bhi, blo):
    """Host numpy mirror of pair_key (bit-identical)."""
    ahi, alo = np.asarray(ahi, np.uint32), np.asarray(alo, np.uint32)
    bhi, blo = np.asarray(bhi, np.uint32), np.asarray(blo, np.uint32)
    swap = (bhi < ahi) | ((bhi == ahi) & (blo < alo))
    xhi, xlo = np.where(swap, bhi, ahi), np.where(swap, blo, alo)
    yhi, ylo = np.where(swap, ahi, bhi), np.where(swap, alo, blo)
    h1x, h2x = hash_pair_np(xhi, xlo)
    h1y, h2y = hash_pair_np(yhi, ylo)
    with np.errstate(over="ignore"):
        khi = fmix32_np(h1x + np.uint32(3) * h1y)
        klo = fmix32_np(h2x ^ (h2y * np.uint32(5)))
    return khi & np.uint32(0x3FFFFFFF), klo
