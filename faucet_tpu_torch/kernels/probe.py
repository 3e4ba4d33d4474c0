"""Batched blocked-Bloom membership probe
(port of faucet_tpu/kernels/probe.py).

`bloom_probe_keys` launches the hand-written CUDA kernel csrc/probe.cu for
CUDA tensors and takes the plain torch version for CPU tensors; nothing
falls back from one to the other. Layout (core/bloom.py): 512-bit block
`block` holds a key's bits; bit j is (h1r + (j+1)*h2) & 511; a SENTINEL
block reads as absent.

Argument types: words int32[W] (uint32 bit patterns, W a multiple of 16);
block, h1r, h2 int64[N] holding uint32 values. Returns bool[N].
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.kernels import build as KB

SENTINEL = 0xFFFFFFFF
BLOCK_WORDS = 16

# kernel launches by bloom_probe_keys (reset and read by chip_smoke.py)
launches = 0


def bloom_probe_keys_plain(words, block, h1r, h2, n_hash: int):
    """Plain torch version of the kernel (any device)."""
    live = block < words.shape[0] // BLOCK_WORDS  # SENTINEL is out of range
    blk = torch.where(live, block, 0)
    j = torch.arange(1, n_hash + 1, device=block.device, dtype=torch.int64)
    bits = (h1r[:, None] + j * h2[:, None]) & 511
    w = u2.from_i32(words[blk[:, None] * BLOCK_WORDS + (bits >> 5)])
    return ((w >> (bits & 31)) & 1).bool().all(dim=1) & live


def bloom_probe_keys(words, block, h1r, h2, n_hash: int):
    """Membership of each key (all n_hash blocked bits set)."""
    global launches
    if not words.is_cuda:
        return bloom_probe_keys_plain(words, block, h1r, h2, n_hash)
    KB.require_cuda("words", words, torch.int32)
    if words.shape[0] % BLOCK_WORDS:
        raise ValueError("words: length must be a multiple of 16")
    n = block.shape[0]
    for name, t in (("block", block), ("h1r", h1r), ("h2", h2)):
        KB.require_cuda(name, t, torch.int64)
        if t.shape[0] != n or t.device != words.device:
            raise ValueError(f"{name}: shape/device mismatch")
    if not 1 <= n_hash <= 16:
        raise ValueError(f"n_hash out of range: {n_hash}")
    out = torch.empty((n,), dtype=torch.bool, device=words.device)
    if n == 0:
        return out
    lib = KB.library()
    KB.check(lib.ft_bloom_probe(words.data_ptr(), words.shape[0],
                                block.data_ptr(), h1r.data_ptr(),
                                h2.data_ptr(), out.data_ptr(), n, n_hash,
                                KB.stream_of(words)), "bloom_probe")
    launches += 1
    return out
