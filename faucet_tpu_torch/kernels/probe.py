"""Blocked-Bloom membership of k-mer codes
(port of faucet_tpu/kernels/probe.py, with the hashing fused in).

`bloom_contains_codes` takes the codes themselves, (khi, klo) with a
mask, and answers whether all n_hash bits of each live code are set. For
CUDA tensors it is ONE launch of the hand-written kernel csrc/probe.cu,
which hashes each code in registers (csrc/hash.cuh); CPU tensors take the
plain torch version, `_block_h1r_h2` then `bloom_probe_keys_plain`.
Nothing falls back from one to the other.

Layout (core/bloom.py): a code's bits live in one 512-bit block; bit j is
(h1r + (j+1)*h2) & 511; a masked code, or a block past the filter's end,
reads as absent.

Argument types: words int32[2**log2_bits / 32] (uint32 bit patterns);
khi, klo int64 of any one shape, holding uint32 values; mask bool,
broadcastable to that shape. Returns bool of khi's shape.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import build as KB

SENTINEL = 0xFFFFFFFF
M32 = 0xFFFFFFFF
BLOCK_BITS = 9          # 512-bit blocks = 16 words = 64 B
BLOCK_WORDS = 1 << (BLOCK_BITS - 5)

# kernel launches by bloom_contains_codes (reset and read by chip_smoke.py)
launches = 0


def _block_from_hash(h1, h2, log2_bits: int, shard_bits: int = 0):
    """(block, h1r, h2) from a key's hashes (see _block_h1r_h2)."""
    local_block_bits = log2_bits - shard_bits - BLOCK_BITS
    block = h1 & ((1 << local_block_bits) - 1)
    if shard_bits:
        block = block | ((h1 >> (32 - shard_bits)) << local_block_bits)
    # bit stream decorrelated from the block choice via h1's high half
    h1r = (h1 >> 16) | ((h1 << 16) & M32)
    return block, h1r, h2


def _block_h1r_h2(khi, klo, log2_bits: int, shard_bits: int = 0):
    """Blocked-Bloom addressing: (block index, rotated h1, h2); bit_j of
    a key = (h1r + (j+1)*h2) & 511 inside `block`."""
    h1, h2 = hash_pair(khi, klo)
    return _block_from_hash(h1, h2, log2_bits, shard_bits)


def bloom_probe_keys_plain(words, block, h1r, h2, n_hash: int):
    """Membership of addressed keys (block, h1r, h2: int64[N]); a block at
    or past the filter's end (SENTINEL included) reads as absent."""
    live = block < words.shape[0] // BLOCK_WORDS
    blk = torch.where(live, block, 0)
    j = torch.arange(1, n_hash + 1, device=block.device, dtype=torch.int64)
    bits = (h1r[:, None] + j * h2[:, None]) & 511
    w = u2.from_i32(words[blk[:, None] * BLOCK_WORDS + (bits >> 5)])
    return ((w >> (bits & 31)) & 1).bool().all(dim=1) & live


def bloom_contains_codes_plain(words, khi, klo, mask, n_hash: int,
                               log2_bits: int, shard_bits: int = 0):
    """Plain torch version of `bloom_contains_codes` (any device)."""
    shape = khi.shape
    block, h1r, h2 = _block_h1r_h2(khi.reshape(-1), klo.reshape(-1),
                                   log2_bits, shard_bits)
    block = torch.where(mask.expand(shape).reshape(-1), block, SENTINEL)
    return bloom_probe_keys_plain(words, block, h1r, h2,
                                  n_hash).reshape(shape)


def _mask_rows(mask, shape):
    """(contiguous mask, period): the flat mask index of lane i is
    i % period. A mask broadcast along leading dimensions (the walk's
    [4, W] frame of a [W] mask) is passed without a copy."""
    m = mask.expand(shape)
    while m.dim() and m.stride(0) == 0:
        m = m[0]
    m = m.contiguous()
    return m, max(m.numel(), 1)


def bloom_contains_codes(words, khi, klo, mask, n_hash: int,
                         log2_bits: int, shard_bits: int = 0):
    """Membership of each masked code (all n_hash blocked bits set)."""
    global launches
    if not words.is_cuda:
        return bloom_contains_codes_plain(words, khi, klo, mask, n_hash,
                                          log2_bits, shard_bits)
    KB.require_cuda("words", words, torch.int32)
    if words.shape[0] != 1 << (log2_bits - 5) or words.data_ptr() % 16:
        raise ValueError(f"words: not a 16-byte aligned filter of "
                         f"2**{log2_bits} bits")
    if not 0 <= log2_bits - shard_bits - BLOCK_BITS < 32:
        raise ValueError(f"2**{log2_bits} bits with shard_bits {shard_bits}")
    if not 1 <= n_hash <= 16:
        raise ValueError(f"n_hash out of range: {n_hash}")
    shape = khi.shape
    if klo.shape != shape:
        raise ValueError("khi, klo: shape mismatch")
    khi, klo = khi.contiguous(), klo.contiguous()
    m, period = _mask_rows(mask, shape)
    for name, t, dt in (("khi", khi, torch.int64), ("klo", klo, torch.int64),
                        ("mask", m, torch.bool)):
        KB.require_cuda(name, t, dt, ndim=t.dim())
        if t.device != words.device:
            raise ValueError(f"{name}: device mismatch")
    out = torch.empty(shape, dtype=torch.bool, device=words.device)
    n = khi.numel()
    if n == 0:
        return out
    KB.check(KB.library().ft_bloom_contains(
        words.data_ptr(), words.shape[0], khi.data_ptr(), klo.data_ptr(),
        m.data_ptr(), period, out.data_ptr(), n, n_hash,
        log2_bits - shard_bits - BLOCK_BITS, shard_bits,
        KB.stream_of(words)), "bloom_contains")
    launches += 1
    return out
