"""Blocked-Bloom membership of k-mer codes
(port of faucet_tpu/kernels/probe.py, with the hashing fused in), and the
blocked layout every filter of the port shares.

Layout (its CUDA twin is csrc/bloom_bits.cuh with csrc/hash.cuh): a
filter is int32 words cut into 512-bit blocks; a code's n_hash bits all
live in one block. `block_address` gives a code's block and rotated h1
from its hashes (core/hashing.py hash_pair), `block_bits` the n_hash bit
offsets inside the block. Every torch user of the layout calls these
two: the plain versions here, in bloom_scatter.py and cascade.py,
core/bloom.py and chip_smoke.py. A masked code, or a block past the
filter's end, reads as absent.

`bloom_contains_codes` takes the codes themselves, (khi, klo) with a
mask, and answers whether all n_hash bits of each live code are set. For
CUDA tensors it is ONE launch of the hand-written kernel csrc/probe.cu,
which hashes each code in registers; CPU tensors take the plain torch
version, `bloom_contains_codes_plain` (kernels/build.py has the one
boundary of every kernel entry).

Argument types: words int32[2**log2_bits / 32] (uint32 bit patterns);
khi, klo int64 of any one shape, holding uint32 values; mask bool,
broadcastable to that shape. Returns bool of khi's shape.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import build as KB
from faucet_tpu_torch.kernels.build import BLOCK_BITS

SENTINEL = 0xFFFFFFFF
M32 = 0xFFFFFFFF
BLOCK_WORDS = 1 << (BLOCK_BITS - 5)  # 512-bit blocks = 16 words = 64 B


def block_address(h1, h2, log2_bits: int, shard_bits: int = 0):
    """(block, h1r, h2) of codes hashed to (h1, h2) in a filter of
    2**log2_bits bits over 2**shard_bits shards: the block's low bits
    from h1, its top shard_bits h1's top bits (the owner prefix), and
    h1r, h1 rotated by 16, which decorrelates the bits from the block."""
    local_block_bits = log2_bits - shard_bits - BLOCK_BITS
    block = h1 & ((1 << local_block_bits) - 1)
    if shard_bits:
        block = block | ((h1 >> (32 - shard_bits)) << local_block_bits)
    h1r = (h1 >> 16) | ((h1 << 16) & M32)
    return block, h1r, h2


def block_bits(h1r, h2, n_hash: int):
    """The n_hash bit offsets of each code inside its block,
    [..., n_hash]: bit j is (h1r + (j+1)*h2) & 511."""
    j = torch.arange(1, n_hash + 1, device=h1r.device, dtype=torch.int64)
    return (h1r[..., None] + j * h2[..., None]) & 511


def bloom_probe_keys_plain(words, block, h1r, h2, n_hash: int):
    """Membership of addressed keys (block, h1r, h2: int64[N]); a block at
    or past the filter's end (SENTINEL included) reads as absent."""
    live = block < words.shape[0] // BLOCK_WORDS
    blk = torch.where(live, block, 0)
    bits = block_bits(h1r, h2, n_hash)
    w = u2.from_i32(words[blk[:, None] * BLOCK_WORDS + (bits >> 5)])
    return ((w >> (bits & 31)) & 1).bool().all(dim=1) & live


def bloom_contains_codes_plain(words, khi, klo, mask, n_hash: int,
                               log2_bits: int, shard_bits: int = 0):
    """Plain torch version of `bloom_contains_codes` (any device)."""
    shape = khi.shape
    block, h1r, h2 = block_address(
        *hash_pair(khi.reshape(-1), klo.reshape(-1)), log2_bits, shard_bits)
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
    local_bits = KB.filter_bits("words", words, log2_bits, shard_bits,
                                n_hash)
    KB.lanes(khi, ("khi", khi, torch.int64), ("klo", klo, torch.int64))
    if mask.dtype != torch.bool:
        raise ValueError(f"mask: expected torch.bool, got {mask.dtype}")
    if not words.is_cuda:
        return bloom_contains_codes_plain(words, khi, klo, mask, n_hash,
                                          log2_bits, shard_bits)
    shape = khi.shape
    khi, klo = khi.contiguous(), klo.contiguous()
    m, period = _mask_rows(mask, shape)
    KB.on_card(("khi", khi), ("klo", klo), ("mask", m),
               filters=(("words", words),))
    out = torch.empty(shape, dtype=torch.bool, device=words.device)
    n = khi.numel()
    if n == 0:
        return out
    KB.launch("bloom_contains", "probe_launches", words.data_ptr(),
              words.shape[0], khi.data_ptr(), klo.data_ptr(), m.data_ptr(),
              period, out.data_ptr(), n, n_hash, local_bits,
              shard_bits, KB.stream_of(words))
    return out
