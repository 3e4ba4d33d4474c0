"""Bloom-cascade insert (port of faucet_tpu/kernels/cascade.py).

For each key in stream order: if filter A holds it, add it to filter B,
else add it to A. `cascade_insert` computes the sort+count formulation the
reference runs on its CPU backend (faucet_tpu/core/bloom.py
cascade_insert_nbs) — the TPU kernel's filter words equal it bit for bit;
see csrc/cascade.cu for the design and the relation of the flags:

1. a stable torch sort groups the batch by key (first occurrence first,
   masked lanes last) — shared by both versions below;
2. the probe kernel (kernels/probe.py) reads pre-batch A and B for each
   key's first occurrence;
3. the apply kernel csrc/cascade.cu ORs the bits in and writes the
   per-lane flags back through the sort permutation.

CUDA tensors launch the kernels, CPU tensors take the plain version;
nothing falls back. The filters are updated IN PLACE (the reference
returns new arrays; the port saves the copy of 20 MB per batch).

Argument types: a_words, b_words int32 (uint32 bit patterns); khi, klo,
block_a, block_b, h1r, h2 int64[N] holding uint32 values; block_a ==
SENTINEL marks a masked lane. Returns (new_b, solid), bool[N].
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.kernels import build as KB
from faucet_tpu_torch.kernels import probe as PK

SENTINEL = 0xFFFFFFFF
_KEY_LAST = (1 << 63) - 1  # sort key of masked lanes: after every key

# kernel launches by cascade_insert (reset and read by chip_smoke.py)
launches = 0


def _sorted_batch(khi, klo, block_a, block_b, h1r, h2, probe):
    """Sort lanes by key (stable: a key's first in-batch occurrence leads
    its run), then probe pre-batch state at each run's first lane — the
    port of the reference's _batch_counts (core/bloom.py) plus its two
    pre-batch probes.

    Returns the sorted lanes' (block_a, block_b, h1r, h2), sidx (sorted
    position -> original lane), seg_start (first sorted position of each
    lane's key run) and the probe function's (in_a, in_b)."""
    n = khi.shape[0]
    key = torch.where(block_a == SENTINEL, _KEY_LAST, u2.sort_key(khi, klo))
    skey, sidx = torch.sort(key, stable=True)
    ba, bb, r1, r2 = (t[sidx] for t in (block_a, block_b, h1r, h2))
    iota = torch.arange(n, device=khi.device)
    head = torch.ones((n,), dtype=torch.bool, device=khi.device)
    head[1:] = skey[1:] != skey[:-1]
    seg_start = torch.cummax(torch.where(head, iota, 0), dim=0).values
    rep = head & (ba != SENTINEL)
    in_a, in_b = probe(torch.where(rep, ba, SENTINEL),
                       torch.where(rep, bb, SENTINEL), r1, r2)
    return ba, bb, r1, r2, sidx, seg_start, in_a, in_b


def bloom_or_plain(words, block, h1r, h2, mask, n_hash: int):
    """OR the n_hash bits of every masked key into `words`, in place.

    torch has no scatter-OR: distinct bit positions are summed per word
    (a sum of distinct bits is their OR), then OR-ed in once per word."""
    j = torch.arange(1, n_hash + 1, device=block.device, dtype=torch.int64)
    bits = (h1r[:, None] + j * h2[:, None]) & 511
    pos = torch.unique(((block[:, None] << 9) | bits)[mask])
    delta = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    delta.index_add_(0, pos >> 5, 1 << (pos & 31))
    words |= u2.to_i32(delta)


def cascade_insert_plain(a_words, b_words, khi, klo, block_a, block_b, h1r,
                         h2, n_hash_a: int, n_hash_b: int):
    """Plain torch version of `cascade_insert` (any device)."""
    def probe(qa, qb, r1, r2):
        return (PK.bloom_probe_keys_plain(a_words, qa, r1, r2, n_hash_a),
                PK.bloom_probe_keys_plain(b_words, qb, r1, r2, n_hash_b))

    ba, bb, r1, r2, sidx, seg_start, in_a, in_b = _sorted_batch(
        khi, klo, block_a, block_b, h1r, h2, probe)
    n = khi.shape[0]
    iota = torch.arange(n, device=khi.device)
    live = ba != SENTINEL
    rep = live & (seg_start == iota)
    dup = torch.zeros_like(rep)
    dup[:-1] = seg_start[1:] == iota[:-1]
    add_b = rep & (in_a | dup)
    add_a = rep & ~in_a
    new_b = torch.zeros_like(rep)
    new_b[sidx] = add_b & ~in_b
    solid = torch.zeros_like(rep)
    solid[sidx] = (in_b[seg_start] | in_a[seg_start] | (iota > seg_start)) \
        & live
    bloom_or_plain(a_words, ba, r1, r2, add_a, n_hash_a)
    bloom_or_plain(b_words, bb, r1, r2, add_b, n_hash_b)
    return new_b, solid


def cascade_insert(a_words, b_words, khi, klo, block_a, block_b, h1r, h2,
                   n_hash_a: int, n_hash_b: int):
    """Cascade-insert a batch; updates a_words/b_words in place and
    returns (new_b, solid) per lane."""
    global launches
    if not a_words.is_cuda:
        return cascade_insert_plain(a_words, b_words, khi, klo, block_a,
                                    block_b, h1r, h2, n_hash_a, n_hash_b)
    for name, t in (("a_words", a_words), ("b_words", b_words)):
        KB.require_cuda(name, t, torch.int32)
        if t.shape[0] % PK.BLOCK_WORDS:
            raise ValueError(f"{name}: length must be a multiple of 16")
    n = khi.shape[0]
    for name, t in (("khi", khi), ("klo", klo), ("block_a", block_a),
                    ("block_b", block_b), ("h1r", h1r), ("h2", h2)):
        KB.require_cuda(name, t, torch.int64)
        if t.shape[0] != n or t.device != a_words.device:
            raise ValueError(f"{name}: shape/device mismatch")
    if not (1 <= n_hash_a <= 16 and 1 <= n_hash_b <= 16):
        raise ValueError(f"n_hash out of range: {n_hash_a}, {n_hash_b}")

    def probe(qa, qb, r1, r2):
        return (PK.bloom_probe_keys(a_words, qa, r1, r2, n_hash_a),
                PK.bloom_probe_keys(b_words, qb, r1, r2, n_hash_b))

    ba, bb, r1, r2, sidx, seg_start, in_a, in_b = _sorted_batch(
        khi, klo, block_a, block_b, h1r, h2, probe)
    new_b = torch.empty((n,), dtype=torch.bool, device=a_words.device)
    solid = torch.empty((n,), dtype=torch.bool, device=a_words.device)
    if n == 0:
        return new_b, solid
    lib = KB.library()
    KB.check(lib.ft_cascade_apply(
        a_words.data_ptr(), a_words.shape[0], b_words.data_ptr(),
        b_words.shape[0], ba.data_ptr(), bb.data_ptr(), r1.data_ptr(),
        r2.data_ptr(), seg_start.data_ptr(), in_a.data_ptr(),
        in_b.data_ptr(), sidx.data_ptr(), new_b.data_ptr(),
        solid.data_ptr(), n, n_hash_a, n_hash_b, KB.stream_of(a_words)),
        "cascade_apply")
    launches += 1
    return new_b, solid
