"""Bit-scatter-OR into a blocked Bloom filter
(port of faucet_tpu/kernels/bloom_scatter.py, with the hashing fused into
the per-key version).

`bloom_insert_codes` ORs each masked code's n_hash blocked bits
(kernels/probe.py `block_address` and `block_bits`) into the filter: for
CUDA tensors ONE launch of csrc/bloom_scatter.cu, which hashes each code
in registers; CPU tensors take `bloom_insert_codes_plain`, the blocked
addressing and `scatter_or_keys_plain`, the plain version of the
reference's (block, h1r, h2) kernel. `scatter_or_bits` ORs raw global bit
positions, `1 << (p & 31)` into word `p >> 5`, with the CUDA kernel of the
same file or its plain version (kernels/build.py has the one boundary of
every kernel entry). A SENTINEL (0xFFFFFFFF) block or position, or one
past the filter's end, is skipped. The filter is updated IN PLACE and
returned (the reference returns a new array).

Argument types: words int32[W] (uint32 bit patterns); khi, klo int64
holding uint32 values and a bool mask, all of one shape; block, h1r, h2,
positions int64[N] holding uint32 values.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import build as KB
from faucet_tpu_torch.kernels.probe import (BLOCK_WORDS, SENTINEL,
                                            block_address, block_bits)


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
    bits = block_bits(h1r, h2, n_hash)
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
    block, h1r, h2 = block_address(
        *hash_pair(khi.reshape(-1), klo.reshape(-1)), log2_bits, shard_bits)
    block = torch.where(mask.reshape(-1), block, SENTINEL)
    return scatter_or_keys_plain(words, block, h1r, h2, n_hash)


def bloom_insert_codes(words, khi, klo, mask, n_hash: int, log2_bits: int,
                       shard_bits: int = 0):
    """OR the n_hash blocked bits of every masked code into the filter of
    2**log2_bits bits; updates `words` in place and returns it."""
    local_bits = KB.filter_bits("words", words, log2_bits, shard_bits,
                                n_hash)
    KB.lanes(khi, ("khi", khi, torch.int64), ("klo", klo, torch.int64),
             ("mask", mask, torch.bool))
    if not words.is_cuda:
        return bloom_insert_codes_plain(words, khi, klo, mask, n_hash,
                                        log2_bits, shard_bits)
    khi, klo, mask = khi.reshape(-1), klo.reshape(-1), mask.reshape(-1)
    KB.on_card(("khi", khi), ("klo", klo), ("mask", mask),
               filters=(("words", words),))
    n = khi.shape[0]
    if n == 0:
        return words
    KB.launch("bloom_insert_codes", "bloom_insert_codes_launches",
              words.data_ptr(), words.shape[0], khi.data_ptr(),
              klo.data_ptr(), mask.data_ptr(), n, n_hash, local_bits,
              shard_bits, KB.stream_of(words))
    return words


def scatter_or_bits(words, positions):
    """OR `1 << (p & 31)` into word `p >> 5` for every position that is
    not SENTINEL and lies inside the filter; in place, returns `words`."""
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError(f"words: expected int32 words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if positions.dtype != torch.int64 or positions.dim() != 1:
        raise ValueError(f"positions: expected int64[N], got "
                         f"{positions.dtype} {tuple(positions.shape)}")
    if not words.is_cuda:
        return scatter_or_bits_plain(words, positions)
    KB.on_card(("words", words), ("positions", positions))
    n = positions.shape[0]
    if n == 0:
        return words
    KB.launch("scatter_or_bits", "scatter_or_bits_launches",
              words.data_ptr(), words.shape[0], positions.data_ptr(), n,
              KB.stream_of(words))
    return words
