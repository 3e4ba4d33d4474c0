"""Device-resident open-addressing hash map for (hi, lo) k-mer keys.

Port of faucet_tpu/core/table.py. Same algorithm, so the slot arrays (not
just the key -> value maps) equal the reference's: the batch is sorted by
key and duplicate keys pre-combined; double-hashing probe rounds follow;
an empty slot goes to the highest ticket that asks for it (scatter-max),
and matched keys combine values per leaf ('add' / 'max').

torch differences, each handled here:
- keys are stored as int32 bit patterns (EMPTY = 0xFFFFFFFF is -1);
- the reference's `mode="drop"` scatters drop out-of-range targets, torch
  raises: every array carries one trailing TRASH row (index `capacity`)
  that absorbs the writes of lanes that write nothing. Real targets stay
  unique (one winner per slot, matches never collide with claims), as in
  the reference, so index_put_ stays deterministic where it matters;
- the reference's device `while_loop` becomes a host loop that checks
  `pending.any()` every ROUND_CHUNK probe rounds (extra rounds are no-ops
  on settled lanes, so results are identical);
- upserts update the table's tensors in place (the reference's jit
  donates them); count/dropped are 0-d int64 tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair

EMPTY = 0xFFFFFFFF  # keys_hi sentinel: valid k<=31 codes have hi < 2^30
EMPTY_I32 = -1      # the same bits as stored
ROUND_CHUNK = 4     # probe rounds between host checks of `pending`


class Table(NamedTuple):
    keys_hi: torch.Tensor           # int32[cap + 1]; row cap is TRASH
    keys_lo: torch.Tensor           # int32[cap + 1]
    vals: Tuple[torch.Tensor, ...]  # each [cap + 1, ...]
    count: torch.Tensor             # int64[] occupied slots
    dropped: torch.Tensor           # int64[] keys lost to probe overflow

    @property
    def capacity(self) -> int:
        return self.keys_hi.shape[0] - 1


def make(cap: int, val_specs: Tuple[Tuple[tuple, torch.dtype], ...] = (),
         device=None) -> Table:
    """val_specs: tuple of (trailing_shape, torch dtype) per value array."""
    assert cap & (cap - 1) == 0, "capacity must be a power of two"
    vals = tuple(torch.zeros((cap + 1,) + tuple(s), dtype=d, device=device)
                 for s, d in val_specs)
    full = lambda: torch.full((cap + 1,), EMPTY_I32, dtype=torch.int32,
                              device=device)
    zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
    return Table(keys_hi=full(), keys_lo=full(), vals=vals, count=zero(),
                 dropped=zero())


def _probe_idx(h1, h2, r: int, cap: int, shard_bits: int = 0):
    """Probe slot for round r (owner-prefixed when shard_bits > 0)."""
    local_cap = cap >> shard_bits
    idx = (h1 + r * h2) & (local_cap - 1)
    if shard_bits:
        idx = idx | ((h1 >> (32 - shard_bits))
                     << (local_cap.bit_length() - 1))
    return idx


def _segment(v, seg, n: int, mode: str):
    """Per-segment sum or max of v's rows, gathered back per lane."""
    out = torch.zeros((n,) + v.shape[1:], dtype=v.dtype, device=v.device)
    if mode == "add":
        out.index_add_(0, seg, v)
    elif mode == "max":
        idx = seg.view((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
        out.scatter_reduce_(0, idx, v, "amax", include_self=False)
    else:
        raise ValueError(f"unknown combine mode {mode!r}")
    return out[seg]


def _dedupe(khi, klo, vals, mask, modes):
    """Sort batch by key, combine duplicate keys' values; returns sorted
    keys, combined values, and a representative mask."""
    n = khi.shape[0]
    khi_m = torch.where(mask, khi, EMPTY)
    klo_m = torch.where(mask, klo, EMPTY)
    skey, sidx = torch.sort(u2.sort_key(khi_m, klo_m), stable=True)
    head = torch.ones((n,), dtype=torch.bool, device=khi.device)
    head[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(head, 0) - 1
    combined = tuple(_segment(v[sidx], seg, n, mode)
                     for v, mode in zip(vals, modes))
    skhi = khi_m[sidx]
    return skhi, klo_m[sidx], combined, head & (skhi != EMPTY)


def _rounds(step, pending, max_rounds: int):
    """Run step(r) for r = 0, 1, ... until no lane is pending (checked
    every ROUND_CHUNK rounds) or max_rounds is reached."""
    r = 0
    while r < max_rounds:
        for _ in range(min(ROUND_CHUNK, max_rounds - r)):
            pending = step(r, pending)
            r += 1
        if not bool(pending.any()):
            break
    return pending


def upsert(tbl: Table, khi, klo, vals: Tuple, mask, modes: Tuple[str, ...],
           max_rounds: int = 128, shard_bits: int = 0) -> Table:
    """Insert-or-combine a batch of keyed values, in place.

    khi/klo: int64[N] uint32 words; vals: tuple of [N, ...] in the
    table's dtypes; mask: bool[N]; modes: per-value 'add' | 'max'."""
    cap = tbl.capacity
    n = khi.shape[0]
    skhi, sklo, cvals, rep = _dedupe(khi, klo, vals, mask, modes)
    h1, h2 = hash_pair(skhi, sklo)
    skhi32, sklo32 = u2.to_i32(skhi), u2.to_i32(sklo)
    ticket = torch.arange(n, device=khi.device)
    claim = torch.full((cap + 1,), -1, dtype=torch.int64, device=khi.device)
    n_new = torch.zeros((), dtype=torch.int64, device=khi.device)

    def step(r, pending):
        nonlocal n_new
        idx = _probe_idx(h1, h2, r, cap, shard_bits)
        cur_hi = tbl.keys_hi[idx]
        is_match = pending & (cur_hi == skhi32) & (tbl.keys_lo[idx]
                                                   == sklo32)
        is_empty = pending & (cur_hi == EMPTY_I32)
        # claim empties: highest ticket wins the slot, deterministically
        claim.scatter_reduce_(0, torch.where(is_empty, idx, cap), ticket,
                              "amax")
        won = is_empty & (claim[idx] == ticket)
        widx = torch.where(won, idx, cap)
        tbl.keys_hi[widx] = skhi32
        tbl.keys_lo[widx] = sklo32
        write = is_match | won
        widx = torch.where(write, idx, cap)
        for tv, cv, mode in zip(tbl.vals, cvals, modes):
            # winners start from zero-initialized slots, so add/max both
            # land the combined batch value directly
            cur = tv[widx]
            new = cur + cv if mode == "add" else torch.maximum(cur, cv)
            tv[widx] = new.to(tv.dtype)
        n_new = n_new + won.sum()
        return pending & ~write

    pending = _rounds(step, rep, max_rounds)
    return tbl._replace(count=tbl.count + n_new,
                        dropped=tbl.dropped + pending.sum())


def lookup(tbl: Table, khi, klo, mask, max_rounds: int = 128,
           shard_bits: int = 0):
    """Returns (found bool[N], idx int64[N]); idx valid where found."""
    cap = tbl.capacity
    h1, h2 = hash_pair(khi, klo)
    khi32, klo32 = u2.to_i32(khi), u2.to_i32(klo)
    found = torch.zeros_like(mask)
    idx_out = torch.full(khi.shape, -1, dtype=torch.int64,
                         device=khi.device)

    def step(r, pending):
        nonlocal found, idx_out
        idx = _probe_idx(h1, h2, r, cap, shard_bits)
        cur_hi = tbl.keys_hi[idx]
        hit = pending & (cur_hi == khi32) & (tbl.keys_lo[idx] == klo32)
        absent = pending & (cur_hi == EMPTY_I32)
        found = found | hit
        idx_out = torch.where(hit, idx, idx_out)
        return pending & ~hit & ~absent

    _rounds(step, mask, max_rounds)
    return found, idx_out


def contains(tbl: Table, khi, klo, mask, max_rounds: int = 128,
             shard_bits: int = 0):
    found, _ = lookup(tbl, khi, klo, mask, max_rounds, shard_bits)
    return found


def occupied_mask(tbl: Table):
    return tbl.keys_hi[:tbl.capacity] != EMPTY_I32
