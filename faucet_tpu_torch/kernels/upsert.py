"""The probe rounds of a hash-table upsert (core/table.py upsert).

`probe_rounds(tbl, skhi, sklo, cvals, rep, modes, max_rounds, shard_bits)`
places a batch that core/table.py `_dedupe` has sorted and combined:
every representative lane (rep) inserts its key or combines its values
into the slot that holds it, round r probing slot (h1 + r * h2) of its
hash; an empty slot goes to the highest ticket (sorted lane index) that
asks for it. Keys and value rows are updated in place; the returned Table
carries new count and dropped tensors. For CUDA tensors every round of
the call is ONE launch of the hand-written kernel csrc/table_upsert.cu,
which stops when no lane is pending and sums count and dropped on the
device (no host read); CPU tensors take the plain torch rounds,
`probe_rounds_plain` (kernels/build.py has the one boundary of every
kernel entry). Both give the same rows [:cap] of every key and value
array and the same count and dropped; only the TRASH row `cap`, which the
torch rounds write and nothing reads, may differ. The kernel replaces no
Pallas kernel: the reference's table is XLA jnp (faucet_tpu/core/table.py).
The probe sequence and the round loop (`probe_idx`, `rounds`) serve
core/table.py `lookup` too.

Argument types: the table's keys int32 [cap + 1] (cap a power of two),
its values int32 or int64 [cap + 1] or [cap + 1, w] with w in 1, 4, 8
(at most three arrays); skhi, sklo int64 [N] holding uint32 words; each
of cvals [N] + its table array's trailing shape, in its dtype; rep bool
[N]; modes "add" or "max", one per value array. All on one device, and
contiguous on CUDA. There, where N exceeds the threads of the grid the
card holds at once, the kernel keeps its lane state in rep: rep may be
overwritten.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch import metrics as M
from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import build as KB

MAX_VALS = 3
WIDTHS = (1, 4, 8)
DTYPES = (torch.int32, torch.int64)
MODES = ("add", "max")
EMPTY_I32 = -1   # an empty slot's keys_hi (0xFFFFFFFF as stored)
ROUND_CHUNK = 4  # torch probe rounds between host checks of `pending`


def probe_idx(h1, h2, r: int, cap: int, shard_bits: int = 0):
    """Probe slot for round r (owner-prefixed when shard_bits > 0)."""
    local_cap = cap >> shard_bits
    idx = (h1 + r * h2) & (local_cap - 1)
    if shard_bits:
        idx = idx | ((h1 >> (32 - shard_bits))
                     << (local_cap.bit_length() - 1))
    return idx


def rounds(step, pending, max_rounds: int):
    """Run step(r) for r = 0, 1, ... until no lane is pending (checked
    every ROUND_CHUNK rounds) or max_rounds is reached. Each step is a
    span `probe_round`, counted in `table_probe_rounds`."""
    r = 0
    while r < max_rounds:
        n = min(ROUND_CHUNK, max_rounds - r)
        for _ in range(n):
            with M.span("probe_round"):
                pending = step(r, pending)
            r += 1
        M.count("table_probe_rounds", n)
        if not bool(M.fetch(pending.any())):
            break
    return pending


def probe_rounds_plain(tbl, skhi, sklo, cvals, rep, modes,
                       max_rounds: int = 128, shard_bits: int = 0):
    """The probe rounds in torch: _dedupe's sorted keys, combined values
    and representative mask into tbl, the highest ticket winning each
    empty slot. Each round a span `probe_round` (see `rounds`)."""
    cap = tbl.capacity
    n = skhi.shape[0]
    h1, h2 = hash_pair(skhi, sklo)
    skhi32, sklo32 = u2.to_i32(skhi), u2.to_i32(sklo)
    ticket = torch.arange(n, device=skhi.device)
    claim = torch.full((cap + 1,), -1, dtype=torch.int64, device=skhi.device)
    n_new = torch.zeros((), dtype=torch.int64, device=skhi.device)

    def step(r, pending):
        nonlocal n_new
        idx = probe_idx(h1, h2, r, cap, shard_bits)
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

    pending = rounds(step, rep, max_rounds)
    return tbl._replace(count=tbl.count + n_new,
                        dropped=tbl.dropped + pending.sum())


def _check(tbl, skhi, sklo, cvals, rep, modes, max_rounds, shard_bits):
    """Refuse what either version does not take (ValueError), on both
    devices; returns each value array's width and the checked tensors,
    (name, tensor, dtype, shape)."""
    if not len(tbl.vals) == len(cvals) == len(modes):
        raise ValueError(f"{len(tbl.vals)} table value arrays, "
                         f"{len(cvals)} batch values, {len(modes)} modes")
    if len(cvals) > MAX_VALS:
        raise ValueError(f"{len(cvals)} value arrays: at most {MAX_VALS}")
    for m in modes:
        if m not in MODES:
            raise ValueError(f"unknown combine mode {m!r}")
    cap = tbl.capacity
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"capacity {cap} is not a power of two")
    if not 0 <= shard_bits <= 16 or cap >> shard_bits < 1:
        raise ValueError(f"shard_bits {shard_bits} for capacity {cap}")
    if max_rounds < 0:
        raise ValueError(f"max_rounds {max_rounds} < 0")
    n = skhi.shape[0] if skhi.dim() == 1 else -1
    want = [("keys_hi", tbl.keys_hi, torch.int32, (cap + 1,)),
            ("keys_lo", tbl.keys_lo, torch.int32, (cap + 1,)),
            ("skhi", skhi, torch.int64, (n,)),
            ("sklo", sklo, torch.int64, (n,)),
            ("rep", rep, torch.bool, (n,)),
            ("count", tbl.count, torch.int64, ()),
            ("dropped", tbl.dropped, torch.int64, ())]
    widths = []
    for j, (tv, cv) in enumerate(zip(tbl.vals, cvals)):
        w = {1: 1, 2: tv.shape[-1]}.get(tv.dim(), 0)
        if tv.dtype not in DTYPES or w not in WIDTHS:
            raise ValueError(f"vals[{j}]: {tv.dtype} {tuple(tv.shape)}; "
                             f"takes int32 or int64 rows of {WIDTHS}")
        widths.append(w)
        want += [(f"vals[{j}]", tv, tv.dtype, (cap + 1,) + tv.shape[1:]),
                 (f"cvals[{j}]", cv, tv.dtype, (n,) + tv.shape[1:])]
    for name, t, dtype, shape in want:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != skhi.device:
            raise ValueError(f"{name}: on {t.device}, skhi on "
                             f"{skhi.device}")
    return widths, want


def probe_rounds(tbl, skhi, sklo, cvals, rep, modes, max_rounds: int = 128,
                 shard_bits: int = 0):
    """Insert or combine the deduplicated batch into tbl; the new Table."""
    widths, named = _check(tbl, skhi, sklo, cvals, rep, modes, max_rounds,
                           shard_bits)
    if not skhi.is_cuda:
        return probe_rounds_plain(tbl, skhi, sklo, cvals, rep, modes,
                                  max_rounds, shard_bits)
    KB.on_card(*((name, t) for name, t, _, _ in named))
    cap = tbl.capacity
    # the claim words and, last, the grid's pending-lane counter: the same
    # allocation as the torch rounds' [cap + 1] (the allocator rounds
    # both up to the same 512-byte block)
    claim = torch.empty((cap + 2,), dtype=torch.int64, device=skhi.device)
    count = torch.empty_like(tbl.count)
    dropped = torch.empty_like(tbl.dropped)
    vargs = []
    for j in range(MAX_VALS):
        if j < len(cvals):
            tv = tbl.vals[j]
            vargs += [tv.data_ptr(), cvals[j].data_ptr(),
                      widths[j] | (tv.dtype == torch.int64) << 8
                      | (modes[j] == "max") << 9]
        else:
            vargs += [None, None, 0]
    KB.launch("table_upsert", "upsert_launches", tbl.keys_hi.data_ptr(),
              tbl.keys_lo.data_ptr(), cap, skhi.data_ptr(), sklo.data_ptr(),
              rep.data_ptr(), skhi.shape[0], claim.data_ptr(),
              tbl.count.data_ptr(), tbl.dropped.data_ptr(), count.data_ptr(),
              dropped.data_ptr(), shard_bits, max_rounds, len(cvals), *vargs,
              KB.stream_of(skhi))
    return tbl._replace(count=count, dropped=dropped)
