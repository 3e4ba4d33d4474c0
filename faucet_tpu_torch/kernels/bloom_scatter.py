"""Bit-scatter-OR into a blocked Bloom filter
(port of faucet_tpu/kernels/bloom_scatter.py).

`scatter_or_keys` ORs each key's n_hash blocked bits, (h1r + (j+1)*h2) &
511 inside 512-bit block `block`, into the filter; `scatter_or_bits` ORs
raw global bit positions, `1 << (p & 31)` into word `p >> 5`. Both launch
the hand-written CUDA kernels of csrc/bloom_scatter.cu for CUDA tensors and
take their plain torch versions for CPU tensors; nothing falls back from
one to the other. A SENTINEL (0xFFFFFFFF) block or position, or one past
the filter's end, is skipped. The filter is updated IN PLACE and returned
(the reference returns a new array).

Argument types: words int32[W] (uint32 bit patterns; W a multiple of 16
for the per-key version); block, h1r, h2, positions int64[N] holding uint32
values.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.kernels import build as KB

SENTINEL = 0xFFFFFFFF
BLOCK_WORDS = 16

# kernel launches by scatter_or_keys / scatter_or_bits (reset and read by
# chip_smoke.py)
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
    """Plain torch version of `scatter_or_keys` (any device)."""
    bloom_or_plain(words, block, h1r, h2,
                   block < words.shape[0] // BLOCK_WORDS, n_hash)
    return words


def scatter_or_bits_plain(words, positions):
    """Plain torch version of `scatter_or_bits` (any device)."""
    live = (positions != SENTINEL) & ((positions >> 5) < words.shape[0])
    _or_positions(words, torch.unique(positions[live]))
    return words


def _check_lanes(words, named):
    n = named[0][1].shape[0]
    for name, t in named:
        KB.require_cuda(name, t, torch.int64)
        if t.shape[0] != n or t.device != words.device:
            raise ValueError(f"{name}: shape/device mismatch")
    return n


def scatter_or_keys(words, block, h1r, h2, n_hash: int):
    """Set the n_hash blocked bits of every key whose block is in range;
    updates `words` in place and returns it."""
    global launches_keys
    if not words.is_cuda:
        return scatter_or_keys_plain(words, block, h1r, h2, n_hash)
    KB.require_cuda("words", words, torch.int32)
    if words.shape[0] % BLOCK_WORDS:
        raise ValueError("words: length must be a multiple of 16")
    n = _check_lanes(words, (("block", block), ("h1r", h1r), ("h2", h2)))
    if not 1 <= n_hash <= 16:
        raise ValueError(f"n_hash out of range: {n_hash}")
    if n == 0:
        return words
    KB.check(KB.library().ft_scatter_or_keys(
        words.data_ptr(), words.shape[0], block.data_ptr(), h1r.data_ptr(),
        h2.data_ptr(), n, n_hash, KB.stream_of(words)), "scatter_or_keys")
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
