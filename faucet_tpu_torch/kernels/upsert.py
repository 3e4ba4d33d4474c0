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
core/table.py `probe_rounds_plain`. Nothing falls back from one to the
other. Both give the same rows [:cap] of every key and value array and
the same count and dropped; only the TRASH row `cap`, which the torch
rounds write and nothing reads, may differ. The kernel replaces no Pallas
kernel: the reference's table is XLA jnp (faucet_tpu/core/table.py).

Argument types: the table's keys int32 [cap + 1] (cap a power of two),
its values int32 or int64 [cap + 1] or [cap + 1, w] with w in 1, 4, 8
(at most three arrays); skhi, sklo int64 [N] holding uint32 words; each
of cvals [N] + its table array's trailing shape, in its dtype; rep bool
[N]; modes "add" or "max", one per value array. All contiguous, on one
device. On CUDA, where N exceeds the threads of the grid the card holds at
once, the kernel keeps its lane state in rep: rep may be overwritten.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch import metrics as M
from faucet_tpu_torch.kernels import build as KB

MAX_VALS = 3
WIDTHS = (1, 4, 8)
DTYPES = (torch.int32, torch.int64)
MODES = ("add", "max")

# kernel launches by probe_rounds (reset and read by tests)
launches = 0


def _check(tbl, skhi, sklo, cvals, rep, modes, max_rounds, shard_bits):
    """Refuse what the kernel does not take (ValueError); returns each
    value array's width."""
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
            ("rep", rep, torch.bool, (n,))]
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
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.device != skhi.device:
            raise ValueError(f"{name}: on {t.device}, skhi on "
                             f"{skhi.device}")
    return widths


def probe_rounds(tbl, skhi, sklo, cvals, rep, modes, max_rounds: int = 128,
                 shard_bits: int = 0):
    """Insert or combine the deduplicated batch into tbl; the new Table."""
    global launches
    widths = _check(tbl, skhi, sklo, cvals, rep, modes, max_rounds,
                    shard_bits)
    if not skhi.is_cuda:
        from faucet_tpu_torch.core import table as T

        return T.probe_rounds_plain(tbl, skhi, sklo, cvals, rep, modes,
                                    max_rounds, shard_bits)
    for name, t in (("count", tbl.count), ("dropped", tbl.dropped)):
        if t.dtype != torch.int64 or t.dim() != 0 or t.device != skhi.device:
            raise ValueError(f"{name}: expected a 0-d torch.int64 on "
                             f"{skhi.device}")
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
    KB.check(KB.library().ft_table_upsert(
        tbl.keys_hi.data_ptr(), tbl.keys_lo.data_ptr(), cap,
        skhi.data_ptr(), sklo.data_ptr(), rep.data_ptr(), skhi.shape[0],
        claim.data_ptr(), tbl.count.data_ptr(), tbl.dropped.data_ptr(),
        count.data_ptr(), dropped.data_ptr(), shard_bits, max_rounds,
        len(cvals), *vargs, KB.stream_of(skhi)), "table_upsert")
    launches += 1
    M.count("upsert_launches")
    return tbl._replace(count=count, dropped=dropped)
