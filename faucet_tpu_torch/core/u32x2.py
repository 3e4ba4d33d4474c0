"""64-bit k-mer codes as (hi, lo) 32-bit words, in torch.

Port of faucet_tpu/core/u32x2.py. torch's uint32 dtype has no shifts,
adds or comparisons, so the port's word rule is:

- in torch ops, words are int64 tensors holding uint32 values; every
  `<<` is masked back to 32 bits (`& M32`), and `>>` is logical because
  the values are non-negative;
- storage (filter words, table keys, spools) keeps the reference's bytes
  as int32 bit patterns (`to_i32` / `from_i32` convert);
- kernels read and write uint32 natively.

Codes of k <= 31 bases fit 62 bits, so `pack` folds a pair into one
non-negative int64 where a single op beats two (walks, sorting).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
I64 = torch.int64


def u32(x, device=None) -> torch.Tensor:
    """uint32-valued array-like -> int64 tensor."""
    return torch.from_numpy(
        np.asarray(x, dtype=np.uint32).astype(np.int64)).to(device)


def to_np_u32(t: torch.Tensor) -> np.ndarray:
    """int64 (uint32-valued) or int32 (bit pattern) tensor -> numpy uint32."""
    return t.detach().cpu().numpy().astype(np.uint32)


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """uint32-valued int64 -> the same 32 bits as int32 (two's complement
    wrap, defined for int64 -> int32 casts)."""
    return t.to(torch.int32)


def from_i32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> uint32-valued int64."""
    return t.to(I64) & M32


def shl2(hi, lo):
    """(hi, lo) << 2, high bits fall off."""
    return ((hi << 2) & M32) | (lo >> 30), (lo << 2) & M32


def shr2(hi, lo):
    """(hi, lo) >> 2 logical."""
    return hi >> 2, (lo >> 2) | ((hi << 30) & M32)


def or_base_low(hi, lo, b):
    """OR a 2-bit value into the lowest bits."""
    return hi, lo | b


def or_base_at(hi, lo, b, bitpos: int):
    """OR a 2-bit value at static bit offset `bitpos` (0 = LSB of lo)."""
    if bitpos >= 32:
        return hi | (b << (bitpos - 32)), lo
    return hi, lo | ((b << bitpos) & M32)


def mask_bits(hi, lo, nbits: int):
    """Keep only the low `nbits` bits of the pair (static nbits)."""
    if nbits >= 64:
        return hi, lo
    if nbits >= 32:
        return hi & ((1 << (nbits - 32)) - 1), lo
    return torch.zeros_like(hi), lo & ((1 << nbits) - 1)


def eq(a_hi, a_lo, b_hi, b_lo):
    return (a_hi == b_hi) & (a_lo == b_lo)


def lt(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def le(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def select(pred, a_hi, a_lo, b_hi, b_lo):
    """Elementwise pred ? a : b on pairs."""
    return torch.where(pred, a_hi, b_hi), torch.where(pred, a_lo, b_lo)


def min_pair(a_hi, a_lo, b_hi, b_lo):
    take_a = lt(a_hi, a_lo, b_hi, b_lo)
    return select(take_a, a_hi, a_lo, b_hi, b_lo)


def pack(hi, lo):
    """Pair -> one int64. Order-preserving for hi < 2**31 (every k <= 31
    code and node key); larger hi wraps negative — see sort_key."""
    return (hi << 32) | lo


def unpack(v):
    return (v >> 32) & M32, v & M32


_SIGN = -(1 << 63)


def sort_key(hi, lo):
    """int64 whose signed order is the unsigned (hi, lo) order.

    Sign-order trap: `(hi << 32) | lo` makes keys with hi >= 2**31
    negative and the all-ones SENTINEL -1, which would sort FIRST; the
    reference's dedupe, batch counts and spool flush need SENTINEL last.
    Flipping the sign bit maps unsigned order onto signed order."""
    return pack(hi, lo) ^ _SIGN


# ---- host-side helpers (numpy / python int) ----------------------------

def to_int(hi, lo):
    """Pair -> uint64 numpy array (host)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)
