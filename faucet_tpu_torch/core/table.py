"""Device-resident open-addressing hash map for (hi, lo) k-mer keys.

Port of faucet_tpu/core/table.py. Same algorithm, so the slot arrays (not
just the key -> value maps) equal the reference's: the reference sorts
the batch by key and pre-combines duplicate keys; double-hashing probe
rounds follow; an empty slot goes to the highest ticket that asks for it
(scatter-max), and matched keys combine values per leaf ('add' / 'max').

torch differences, each handled here:
- keys are stored as int32 bit patterns (EMPTY = 0xFFFFFFFF is -1);
- the reference's `mode="drop"` scatters drop out-of-range targets, torch
  raises: every array carries one trailing TRASH row (index `capacity`)
  that absorbs the writes of lanes that write nothing. Real targets stay
  unique (one winner per slot, matches never collide with claims), as in
  the reference, so index_put_ stays deterministic where it matters;
- an upsert on CUDA tensors hands its batch, unsorted and with duplicate
  keys, to ONE launch of a kernel that runs every probe round of the
  call, claiming empty slots by key and combining duplicates on the table
  (kernels/upsert.py, csrc/table_upsert.cu); on CPU tensors the batch is
  sorted and combined (kernels/upsert.py `dedupe`) and the torch rounds
  run in a host loop (kernels/upsert.py `rounds`), which `lookup` runs on
  both devices, checking `pending.any()` every ROUND_CHUNK probe rounds
  (extra rounds are no-ops on settled lanes, so results are identical);
- upserts update the table's tensors in place (the reference's jit
  donates them); count/dropped are 0-d int64 tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from faucet_tpu_torch import metrics as M
from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import upsert as KU
from faucet_tpu_torch.kernels.upsert import EMPTY_I32, probe_idx, rounds


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


def upsert(tbl: Table, khi, klo, vals: Tuple, mask, modes: Tuple[str, ...],
           max_rounds: int = 128, shard_bits: int = 0) -> Table:
    """Insert-or-combine a batch of keyed values, in place.

    khi/klo: int64[N] uint32 words; vals: tuple of [N, ...] in the
    table's dtypes; mask: bool[N]; modes: per-value 'add' | 'max'. One
    kernel launch on CUDA tensors, the sort, combine and torch rounds on
    CPU ones (kernels/upsert.py probe_rounds). A span `upsert`."""
    with M.span("upsert"):
        return KU.probe_rounds(tbl, khi, klo, vals, mask, modes, max_rounds,
                               shard_bits)


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
        idx = probe_idx(h1, h2, r, cap, shard_bits)
        cur_hi = tbl.keys_hi[idx]
        hit = pending & (cur_hi == khi32) & (tbl.keys_lo[idx] == klo32)
        absent = pending & (cur_hi == EMPTY_I32)
        found = found | hit
        idx_out = torch.where(hit, idx, idx_out)
        return pending & ~hit & ~absent

    rounds(step, mask, max_rounds)
    return found, idx_out


def contains(tbl: Table, khi, klo, mask, max_rounds: int = 128,
             shard_bits: int = 0):
    found, _ = lookup(tbl, khi, klo, mask, max_rounds, shard_bits)
    return found


def occupied_mask(tbl: Table):
    return tbl.keys_hi[:tbl.capacity] != EMPTY_I32
