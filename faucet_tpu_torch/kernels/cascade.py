"""Bloom-cascade insert (port of faucet_tpu/kernels/cascade.py, with the
hashing fused in).

For each key in stream order: if filter A holds it, add it to filter B,
else add it to A. `cascade_insert` computes the formulation the reference
runs on its CPU backend (faucet_tpu/core/bloom.py cascade_insert_nbs);
the TPU kernel's filter words equal it bit for bit. It takes the codes
themselves: a lane is live when its mask is set and its hi word is not
0xFFFFFFFF (the reference's sort key of a masked lane).

CUDA tensors take csrc/cascade.cu: three launches (count, apply, clear)
around a scratch hash table that this module keeps per device and size,
and no sort (see the source for the design). CPU tensors take
`cascade_insert_plain`, which groups the batch with a stable sort as the
reference does (kernels/build.py has the one boundary of every kernel
entry). The filters are updated IN PLACE (the reference returns new
arrays; the port saves the copy of 20 MB per batch).

Argument types: a_words, b_words int32 (uint32 bit patterns) of 2**la and
2**lb bits; khi, klo int64[N] holding uint32 values; mask bool[N].
Returns (new_b, solid), bool[N].
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import build as KB
from faucet_tpu_torch.kernels import probe as PK
from faucet_tpu_torch.kernels.bloom_scatter import bloom_or_plain

SENTINEL = 0xFFFFFFFF
_KEY_LAST = (1 << 63) - 1  # sort key of masked lanes: after every key

# a call is counted in the tally as `cascade_launches` (one per call; each
# call is three device launches) and again under the Pallas variant of
# the reference's cascade_insert_fused that it stands in for (one kernel
# serves all three here), `cascade_<variant>_launches`: "sparse" where the
# caller flags a mostly masked batch (_kernel_sparse), "multi_tile" where
# filter A is larger than the reference's one tile (_kernel), else "dense"
# (_kernel_v2)
VARIANTS = ("dense", "sparse", "multi_tile")
_COUNTS = {v: ("cascade_launches", f"cascade_{v}_launches")
           for v in VARIANTS}
# the reference's one tile: filters A and B together in 22 MiB of VMEM
_ONE_TILE_WORDS = (22 << 20) // 4

# scratch hash tables, int32[n_slots, 4] (16-byte slots, all ones when
# empty), by (device, n_slots); each call leaves its table clean
_tables = {}


def n_slots_for(n: int) -> int:
    """Slots for an n-lane batch: the least power of two with n <= 0.6 *
    slots (load factor <= 0.6 with every lane live and distinct)."""
    return max(16, 1 << (-(-5 * n // 3) - 1).bit_length())


def _table(device, n_slots: int):
    t = _tables.get((device, n_slots))
    if t is None:
        t = torch.full((n_slots, 4), -1, dtype=torch.int32, device=device)
        _tables[(device, n_slots)] = t
    return t


def group_by_key(khi, klo, mask):
    """The reference's grouping of a batch by key: a stable sort puts
    each key's lanes together, first occurrence first, dead lanes last. A
    lane is live when its mask is set and its hi word is not SENTINEL.

    Returns, in sorted order: sidx (the lane of each position), slive,
    seg_start (the position of the group's first lane), rep (live group
    heads) and dup (heads of a group of two or more lanes)."""
    live = mask & (khi != SENTINEL)
    key = torch.where(live, u2.sort_key(khi, klo), _KEY_LAST)
    skey, sidx = torch.sort(key, stable=True)
    n = khi.shape[0]
    iota = torch.arange(n, device=khi.device)
    head = torch.ones((n,), dtype=torch.bool, device=khi.device)
    head[1:] = skey[1:] != skey[:-1]
    seg_start = torch.cummax(torch.where(head, iota, 0), dim=0).values
    slive = live[sidx]
    dup = torch.zeros_like(head)
    dup[:-1] = seg_start[1:] == iota[:-1]
    return sidx, slive, seg_start, head & slive, dup


def lane_flags(sidx, slive, seg_start, add_b, in_a, in_b):
    """(new_b, solid) per lane, in lane order, from the sorted groups and
    the pre-batch membership of each group's head: new_b marks the head
    that first puts its key into B; a lane is solid when its key was in A
    or B before the batch or occurs earlier in the batch."""
    iota = torch.arange(sidx.shape[0], device=sidx.device)
    new_b = torch.zeros_like(slive)
    new_b[sidx] = add_b & ~in_b
    solid = torch.zeros_like(slive)
    solid[sidx] = (in_b[seg_start] | in_a[seg_start] | (iota > seg_start)) \
        & slive
    return new_b, solid


def cascade_insert_plain(a_words, b_words, khi, klo, mask, la: int, lb: int,
                         shard_bits: int, n_hash_a: int, n_hash_b: int):
    """Plain torch version of `cascade_insert` (any device): the
    reference's sort+count formulation. The batch is grouped by key
    (`group_by_key`); pre-batch A and B are probed at each key's first
    lane."""
    h1, h2 = hash_pair(khi, klo)
    block_a, h1r, h2 = PK.block_address(h1, h2, la, shard_bits)
    block_b, _, _ = PK.block_address(h1, h2, lb, shard_bits)
    sidx, slive, seg_start, rep, dup = group_by_key(khi, klo, mask)
    ba, bb, r1, r2 = (t[sidx] for t in (block_a, block_b, h1r, h2))
    in_a = PK.bloom_probe_keys_plain(a_words, torch.where(rep, ba, SENTINEL),
                                     r1, r2, n_hash_a)
    in_b = PK.bloom_probe_keys_plain(b_words, torch.where(rep, bb, SENTINEL),
                                     r1, r2, n_hash_b)
    add_b = rep & (in_a | dup)
    add_a = rep & ~in_a
    bloom_or_plain(a_words, ba, r1, r2, add_a, n_hash_a)
    bloom_or_plain(b_words, bb, r1, r2, add_b, n_hash_b)
    return lane_flags(sidx, slive, seg_start, add_b, in_a, in_b)


def cascade_insert(a_words, b_words, khi, klo, mask, la: int, lb: int,
                   shard_bits: int, n_hash_a: int, n_hash_b: int,
                   sparse: bool = False):
    """Cascade-insert a batch; updates a_words/b_words in place and
    returns (new_b, solid) per lane. `sparse` is the reference's hint that
    the mask is mostly False: the kernel is the same (dead lanes exit at
    once), and the hint only names the variant the launch is counted as."""
    bits_a = KB.filter_bits("a_words", a_words, la, shard_bits, n_hash_a)
    bits_b = KB.filter_bits("b_words", b_words, lb, shard_bits, n_hash_b)
    KB.lanes(khi, ("khi", khi, torch.int64), ("klo", klo, torch.int64),
             ("mask", mask, torch.bool))
    n = khi.shape[0] if khi.dim() == 1 else -1
    if not 0 <= n < 1 << 28:
        raise ValueError(f"khi {tuple(khi.shape)}: one dimension of at "
                         f"most 2**28 lanes")
    if not a_words.is_cuda:
        return cascade_insert_plain(a_words, b_words, khi, klo, mask, la, lb,
                                    shard_bits, n_hash_a, n_hash_b)
    KB.on_card(("khi", khi), ("klo", klo), ("mask", mask),
               filters=(("a_words", a_words), ("b_words", b_words)))
    dev = a_words.device
    new_b = torch.empty((n,), dtype=torch.bool, device=dev)
    solid = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return new_b, solid
    n_slots = n_slots_for(n)
    table = _table(dev, n_slots)
    lanes = torch.empty((n,), dtype=torch.int32, device=dev)
    KB.launch("cascade_insert",
              _COUNTS[reference_variant(a_words.shape[0], b_words.shape[0],
                                        sparse)],
              a_words.data_ptr(), a_words.shape[0], b_words.data_ptr(),
              b_words.shape[0], khi.data_ptr(), klo.data_ptr(),
              mask.data_ptr(), n, bits_a, bits_b, shard_bits, n_hash_a,
              n_hash_b, table.data_ptr(), n_slots, lanes.data_ptr(),
              new_b.data_ptr(), solid.data_ptr(), KB.stream_of(a_words),
              # a launch that failed may leave slots claimed: drop the table
              on_fail=lambda: _tables.pop((dev, n_slots)))
    return new_b, solid


def reference_variant(wa: int, wb: int, sparse: bool) -> str:
    """The variant (of VARIANTS) a call on filters of wa and wb words is
    counted as."""
    if sparse:
        return "sparse"
    return "multi_tile" if wa > _ONE_TILE_WORDS - wb else "dense"
