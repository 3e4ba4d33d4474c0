"""Bit-scatter-OR into a blocked Bloom filter
(port of faucet_tpu/kernels/bloom_scatter.py, with the hashing fused into
the per-key version).

`bloom_insert_codes` ORs each masked code's n_hash blocked bits, (h1r +
(j+1)*h2) & 511 inside the code's 512-bit block, into the filter: for
CUDA tensors ONE launch of csrc/bloom_scatter.cu, which hashes each code
in registers; CPU tensors take `bloom_insert_codes_plain`, the blocked
addressing (kernels/probe.py `_block_h1r_h2`) and `scatter_or_keys_plain`,
the plain version of the reference's (block, h1r, h2) kernel.
`scatter_or_bits` ORs raw global bit positions, `1 << (p & 31)` into word
`p >> 5`, with the CUDA kernel of the same file or its plain version.
Nothing falls back from one to the other. A SENTINEL (0xFFFFFFFF) block
or position, or one past the filter's end, is skipped. The filter is
updated IN PLACE and returned (the reference returns a new array).

Argument types: words int32[W] (uint32 bit patterns); khi, klo int64
holding uint32 values and a bool mask, all of one shape; block, h1r, h2,
positions int64[N] holding uint32 values.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.kernels import build as KB
from faucet_tpu_torch.kernels.probe import BLOCK_BITS, _block_h1r_h2

SENTINEL = 0xFFFFFFFF
BLOCK_WORDS = 16

# kernel launches by bloom_insert_codes / scatter_or_bits (reset and read
# by chip_smoke.py)
launches_keys = 0
launches_bits = 0


def _or_positions(words, pos):
    """OR the bits at distinct global positions into `words`, in place.

    torch has no scatter-OR: distinct bit positions are summed per word (a
    sum of distinct bits is their OR), then OR-ed in once per word."""
    delta = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    delta.index_add_(0, pos >> 5, 1 << (pos & 31))
    words |= u2.to_i32(delta)


def bloom_or_plain(words, block, h1r, h2, mask, n_hash: int):
    """OR the n_hash bits of every masked key into `words`, in place (the
    plain version of the per-key kernel; the cascade's plain version uses
    it with its own masks)."""
    j = torch.arange(1, n_hash + 1, device=block.device, dtype=torch.int64)
    bits = (h1r[:, None] + j * h2[:, None]) & 511
    _or_positions(words, torch.unique(((block[:, None] << 9) | bits)[mask]))


def scatter_or_keys_plain(words, block, h1r, h2, n_hash: int):
    """Plain torch version of the reference's `scatter_or_keys` (any
    device): the keys come addressed as (block, h1r, h2)."""
    bloom_or_plain(words, block, h1r, h2,
                   block < words.shape[0] // BLOCK_WORDS, n_hash)
    return words


def scatter_or_bits_plain(words, positions):
    """Plain torch version of `scatter_or_bits` (any device)."""
    live = (positions != SENTINEL) & ((positions >> 5) < words.shape[0])
    _or_positions(words, torch.unique(positions[live]))
    return words


def bloom_insert_codes_plain(words, khi, klo, mask, n_hash: int,
                             log2_bits: int, shard_bits: int = 0):
    """Plain torch version of `bloom_insert_codes` (any device): the
    blocked addressing, then `scatter_or_keys_plain`."""
    block, h1r, h2 = _block_h1r_h2(khi.reshape(-1), klo.reshape(-1),
                                   log2_bits, shard_bits)
    block = torch.where(mask.reshape(-1), block, SENTINEL)
    return scatter_or_keys_plain(words, block, h1r, h2, n_hash)


def _check_lanes(words, named):
    n = named[0][1].shape[0]
    for name, t in named:
        KB.require_cuda(name, t, torch.int64)
        if t.shape[0] != n or t.device != words.device:
            raise ValueError(f"{name}: shape/device mismatch")
    return n


def bloom_insert_codes(words, khi, klo, mask, n_hash: int, log2_bits: int,
                       shard_bits: int = 0):
    """OR the n_hash blocked bits of every masked code into the filter of
    2**log2_bits bits; updates `words` in place and returns it."""
    global launches_keys
    if not words.is_cuda:
        return bloom_insert_codes_plain(words, khi, klo, mask, n_hash,
                                        log2_bits, shard_bits)
    KB.require_cuda("words", words, torch.int32)
    if words.shape[0] != 1 << (log2_bits - 5) or words.data_ptr() % 16:
        raise ValueError(f"words: not a 16-byte aligned filter of "
                         f"2**{log2_bits} bits")
    if not 0 <= log2_bits - shard_bits - BLOCK_BITS < 32:
        raise ValueError(f"2**{log2_bits} bits with shard_bits {shard_bits}")
    if not 1 <= n_hash <= 16:
        raise ValueError(f"n_hash out of range: {n_hash}")
    khi, klo = khi.reshape(-1), klo.reshape(-1)
    mask = mask.reshape(-1)
    n = _check_lanes(words, (("khi", khi), ("klo", klo)))
    KB.require_cuda("mask", mask, torch.bool)
    if mask.shape[0] != n or mask.device != words.device:
        raise ValueError("mask: shape/device mismatch")
    if n == 0:
        return words
    KB.check(KB.library().ft_bloom_insert_codes(
        words.data_ptr(), words.shape[0], khi.data_ptr(), klo.data_ptr(),
        mask.data_ptr(), n, n_hash, log2_bits - shard_bits - BLOCK_BITS,
        shard_bits, KB.stream_of(words)), "bloom_insert_codes")
    launches_keys += 1
    return words


def scatter_or_bits(words, positions):
    """OR `1 << (p & 31)` into word `p >> 5` for every position that is
    not SENTINEL and lies inside the filter; in place, returns `words`."""
    global launches_bits
    if not words.is_cuda:
        return scatter_or_bits_plain(words, positions)
    KB.require_cuda("words", words, torch.int32)
    n = _check_lanes(words, (("positions", positions),))
    if n == 0:
        return words
    KB.check(KB.library().ft_scatter_or_bits(
        words.data_ptr(), words.shape[0], positions.data_ptr(), n,
        KB.stream_of(words)), "scatter_or_bits")
    launches_bits += 1
    return words
