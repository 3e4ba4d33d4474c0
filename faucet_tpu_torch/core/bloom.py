"""Blocked Bloom filters and the two-level solidity cascade, in torch.

Port of faucet_tpu/core/bloom.py, Bloom mode only (the exact-table mode,
cfg.exact, is not ported: ROADMAP.md). A filter is an int32 word array
(uint32 bit patterns) of 512-bit blocks; a key's n_hash bits all live in
one block, bit j = (h1r + (j+1)*h2) & 511, so a probe is one 64-byte
read. Membership and cascade inserts go through kernels/probe.py and
kernels/cascade.py, which launch the CUDA kernels for CUDA tensors and
take their plain torch versions for CPU tensors.

Within a batch the cascade keeps the reference's sequential semantics by
counting duplicate keys: a k-mer seen twice in one batch is solid.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import cascade as CK
from faucet_tpu_torch.kernels import probe as PK

SENTINEL = 0xFFFFFFFF
M32 = 0xFFFFFFFF


class Bloom(NamedTuple):
    words: torch.Tensor  # int32[2**log2_bits / 32]


def make_bloom(log2_bits: int, device=None) -> Bloom:
    assert log2_bits >= 5
    return Bloom(words=torch.zeros((1 << (log2_bits - 5),),
                                   dtype=torch.int32, device=device))


BLOCK_BITS = 9          # 512-bit blocks = 16 words = 64 B
BLOCK_WORDS = 1 << (BLOCK_BITS - 5)


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


def _block_and_bits(khi, klo, n_hash: int, log2_bits: int,
                    shard_bits: int = 0):
    """(block [...], bits [..., n_hash] in [0, 512))."""
    block, h1r, h2 = _block_h1r_h2(khi, klo, log2_bits, shard_bits)
    j = torch.arange(1, n_hash + 1, device=khi.device, dtype=torch.int64)
    return block, (h1r[..., None] + j * h2[..., None]) & 511


def bloom_insert(b: Bloom, khi, klo, mask, n_hash: int,
                 log2_bits: int, shard_bits: int = 0) -> Bloom:
    """OR all probe bits of the masked keys into the filter (in place).
    Plain torch on any device: the pipeline inserts only through the
    cascade kernel, as the reference's does on the TPU."""
    block, h1r, h2 = _block_h1r_h2(khi.reshape(-1), klo.reshape(-1),
                                   log2_bits, shard_bits)
    CK.bloom_or_plain(b.words, block, h1r, h2, mask.reshape(-1), n_hash)
    return b


def bloom_contains(b: Bloom, khi, klo, mask, n_hash: int, log2_bits: int,
                   shard_bits: int = 0):
    """Membership probes (the probe kernel on CUDA tensors)."""
    block, h1r, h2 = _block_h1r_h2(khi.reshape(-1), klo.reshape(-1),
                                   log2_bits, shard_bits)
    block = torch.where(mask.reshape(-1), block, SENTINEL)
    return PK.bloom_probe_keys(b.words, block, h1r, h2,
                               n_hash).reshape(khi.shape)


# ---- solidity cascade --------------------------------------------------


class Cascade(NamedTuple):
    """Filter A (seen >= 1) and filter B (solid, seen >= 2). The two
    tables are the reference's exact-mode slots, kept dummy-sized so
    checkpoints share its layout."""
    a_bloom: Bloom
    b_bloom: Bloom
    a_table: T.Table
    b_table: T.Table


def make_cascade(cfg, device=None) -> Cascade:
    if cfg.exact:
        raise NotImplementedError(
            "exact mode (cfg.exact) is not ported to faucet_tpu_torch; "
            "see ROADMAP.md (exact mode)")
    dummy_cap = max(2, 2 * cfg.n_shards)
    return Cascade(make_bloom(cfg.bloom_a_bits.bit_length() - 1, device),
                   make_bloom(cfg.bloom_b_bits.bit_length() - 1, device),
                   T.make(dummy_cap, device=device),
                   T.make(dummy_cap, device=device))


def cascade_insert(c: Cascade, khi, klo, mask, cfg) -> Cascade:
    """Phase-1 load: if A contains k: B.add(k) else A.add(k), batched."""
    return cascade_insert_nb(c, khi, klo, mask, cfg)[0]


def cascade_insert_nb(c: Cascade, khi, klo, mask, cfg
                      ) -> Tuple[Cascade, torch.Tensor]:
    c, new_b, _ = cascade_insert_nbs(c, khi, klo, mask, cfg)
    return c, new_b


def cascade_insert_nbs(c: Cascade, khi, klo, mask, cfg
                       ) -> Tuple[Cascade, torch.Tensor, torch.Tensor]:
    """cascade_insert + per-lane (new_b, solid) flags: new_b marks the lane
    whose insert first promoted its k-mer into B; solid is B membership as
    of the lane's own insert (in B or A before the batch, or an earlier
    in-batch occurrence).

    The filters of `c` are updated in place and `c` is returned. Mostly
    masked input (the node-endpoint inserts) needs no path of its own: the
    kernel's sort packs the live lanes in front."""
    sb = cfg.shard_bits
    la = cfg.bloom_a_bits.bit_length() - 1
    lb = cfg.bloom_b_bits.bit_length() - 1
    h1, h2 = hash_pair(khi, klo)
    block_a, h1r, h2 = _block_from_hash(h1, h2, la, sb)
    block_b, _, _ = _block_from_hash(h1, h2, lb, sb)
    block_a = torch.where(mask, block_a, SENTINEL)
    new_b, solid = CK.cascade_insert(c.a_bloom.words, c.b_bloom.words, khi,
                                     klo, block_a, block_b, h1r, h2,
                                     cfg.n_hash_a, cfg.n_hash_b)
    return c, new_b, solid


def cascade_solid(c: Cascade, khi, klo, mask, cfg):
    """Membership in B — the only query the graph phases use."""
    lb = cfg.bloom_b_bits.bit_length() - 1
    return bloom_contains(c.b_bloom, khi, klo, mask, cfg.n_hash_b, lb,
                          cfg.shard_bits)
