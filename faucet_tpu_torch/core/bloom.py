"""Blocked Bloom filters and the two-level solidity cascade, in torch.

Port of faucet_tpu/core/bloom.py, with its exact-table mode (cfg.exact).
A filter is an int32 word array (uint32 bit patterns) of 512-bit blocks;
a key's n_hash bits all live in one block (kernels/probe.py
`block_address` and `block_bits`), so a probe is one 64-byte read.
Membership, plain inserts and cascade inserts go through kernels/probe.py,
kernels/bloom_scatter.py and kernels/cascade.py, which launch the CUDA
kernels for CUDA tensors and take their plain torch versions for CPU
tensors. All three take the codes themselves: their kernels hash in
registers, one launch per membership query and per plain insert.

Within a batch the cascade keeps the reference's sequential semantics by
counting duplicate keys: a k-mer seen twice in one batch is solid.

Exact mode (the golden mode) keeps A and B as hash tables
(core/table.py) and takes no kernel of this module, as the reference
takes no Pallas path: a batch is grouped by key as the cascade's plain
version groups it, then `T.contains` and `T.upsert` run on A and B.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.kernels import bloom_scatter as SK
from faucet_tpu_torch.kernels import cascade as CK
from faucet_tpu_torch.kernels import probe as PK


class Bloom(NamedTuple):
    words: torch.Tensor  # int32[2**log2_bits / 32]


def make_bloom(log2_bits: int, device=None) -> Bloom:
    assert log2_bits >= 5
    return Bloom(words=torch.zeros((1 << (log2_bits - 5),),
                                   dtype=torch.int32, device=device))


def bloom_insert(b: Bloom, khi, klo, mask, n_hash: int,
                 log2_bits: int, shard_bits: int = 0) -> Bloom:
    """OR all probe bits of the masked keys into the filter (in place).
    CUDA tensors take one launch of the scatter-OR kernel, hashing
    included (kernels/bloom_scatter.py), CPU tensors its plain version,
    as the reference's runs its Pallas kernel off the CPU. The pipeline
    itself inserts only through the cascade kernel."""
    SK.bloom_insert_codes(b.words, khi, klo, mask, n_hash, log2_bits,
                          shard_bits)
    return b


def bloom_contains(b: Bloom, khi, klo, mask, n_hash: int, log2_bits: int,
                   shard_bits: int = 0):
    """Membership probes: one launch of the probe kernel on CUDA tensors
    (hashing included); mask broadcasts to khi's shape."""
    return PK.bloom_contains_codes(b.words, khi, klo, mask, n_hash,
                                   log2_bits, shard_bits)


# ---- solidity cascade --------------------------------------------------


class Cascade(NamedTuple):
    """Filter A (seen >= 1) and filter B (solid, seen >= 2): two Blooms,
    or in exact mode two tables. The unused pair is kept dummy-sized so
    checkpoints share the reference's layout."""
    a_bloom: Bloom
    b_bloom: Bloom
    a_table: T.Table
    b_table: T.Table


def make_cascade(cfg, device=None) -> Cascade:
    # the reference's dummies stay splittable into n_shards pieces
    dummy_log2 = PK.BLOCK_BITS + cfg.shard_bits
    dummy_cap = max(2, 2 * cfg.n_shards)
    if cfg.exact:
        return Cascade(make_bloom(dummy_log2, device),
                       make_bloom(dummy_log2, device),
                       T.make(cfg.cascade_cap_a, device=device),
                       T.make(cfg.cascade_cap_b, device=device))
    return Cascade(make_bloom(cfg.bloom_a_bits.bit_length() - 1, device),
                   make_bloom(cfg.bloom_b_bits.bit_length() - 1, device),
                   T.make(dummy_cap, device=device),
                   T.make(dummy_cap, device=device))


def cascade_insert_nbs(c: Cascade, khi, klo, mask, cfg, sparse: bool = False
                       ) -> Tuple[Cascade, torch.Tensor, torch.Tensor]:
    """Phase-1 load: if A contains k: B.add(k) else A.add(k), batched;
    returns the cascade and per-lane (new_b, solid) flags: new_b marks the
    lane whose insert first promoted its k-mer into B; solid is B
    membership as of the lane's own insert (in B or A before the batch,
    or an earlier in-batch occurrence).

    The filters of `c` are updated in place and `c` is returned. Mostly
    masked input (the node-endpoint inserts) needs no path of its own: the
    kernel's dead lanes exit at once. `sparse` flags such input as the
    reference's callers do; it only names the variant the launch is
    counted as (kernels/cascade.py)."""
    if cfg.exact:
        return _exact_insert(c, khi, klo, mask, cfg)
    new_b, solid = CK.cascade_insert(
        c.a_bloom.words, c.b_bloom.words, khi, klo, mask,
        cfg.bloom_a_bits.bit_length() - 1, cfg.bloom_b_bits.bit_length() - 1,
        cfg.shard_bits, cfg.n_hash_a, cfg.n_hash_b, sparse=sparse)
    return c, new_b, solid


def _exact_insert(c: Cascade, khi, klo, mask, cfg):
    """The table branch: membership of each key's first lane in A and B
    before the batch, then upserts of the keys new to A and of the keys
    promoted into B (seen before, or twice in the batch)."""
    sb = cfg.shard_bits
    sidx, slive, seg_start, rep, dup = CK.group_by_key(khi, klo, mask)
    skhi, sklo = khi[sidx], klo[sidx]
    in_a = T.contains(c.a_table, skhi, sklo, rep, shard_bits=sb)
    in_b = T.contains(c.b_table, skhi, sklo, rep, shard_bits=sb)
    add_b = rep & (in_a | dup)
    new_b, solid = CK.lane_flags(sidx, slive, seg_start, add_b, in_a, in_b)
    return c._replace(
        a_table=T.upsert(c.a_table, skhi, sklo, (), rep & ~in_a, modes=(),
                         shard_bits=sb),
        b_table=T.upsert(c.b_table, skhi, sklo, (), add_b, modes=(),
                         shard_bits=sb)), new_b, solid


def cascade_solid(c: Cascade, khi, klo, mask, cfg):
    """Membership in B — the only query the graph phases use."""
    if cfg.exact:
        mask = torch.broadcast_to(mask, khi.shape)
        return T.contains(c.b_table, khi.reshape(-1), klo.reshape(-1),
                          mask.reshape(-1),
                          shard_bits=cfg.shard_bits).reshape(khi.shape)
    lb = cfg.bloom_b_bits.bit_length() - 1
    return bloom_contains(c.b_bloom, khi, klo, mask, cfg.n_hash_b, lb,
                          cfg.shard_bits)
