"""Hash-table upserts (core/table.py upsert, core/scan.py scan_batch).

Two entries, one kernel (csrc/table_upsert.cu) on CUDA tensors:

- `probe_rounds(tbl, khi, klo, vals, mask, modes, max_rounds,
  shard_bits)` inserts a batch of keyed values, or combines them into the
  slot that holds their key: round r probes slot (h1 + r * h2) of the
  key's hash, and an empty slot goes to the largest key that asks for it.
  The batch comes as it is, unsorted and with duplicate keys.
- `upsert_lanes(tbl, idx, cnt, K, khi, klo, vals, modes, slots, rows,
  max_rounds, shard_bits)` does the same for the update lanes of a scan
  batch where the scan leaves them: `idx, cnt` as kernels/compact.py
  mask_indices lists them, K at a time in lane order, each chunk placed
  after the one before it, as successive `probe_rounds` calls would. The
  lanes' keys and value rows are read from the scan's flat grids; a
  junction table's cov8 and dist8 rows are built from the six slot fields
  (`slots`). The count is never read on the host. The lanes taken and the
  chunks run are counted in the tally as `upsert_lanes` and
  `upsert_chunks` (on the card summed on the device and read with the
  counters, metrics.py).

On CUDA tensors each entry is ONE launch (tally `upsert_launches`),
which sums count and dropped on the device. CPU tensors take the plain
versions (kernels/build.py has the one boundary of every kernel entry):
`dedupe` sorts the batch by key and combines duplicate keys' values, then
`probe_rounds_plain` runs the torch rounds, the highest ticket (sorted
lane index) winning each empty slot; `upsert_lanes_plain` gathers each
chunk, builds its junction rows with `rows` and does the same. Both
versions give the same rows [:cap] of every key and value array and the
same count and dropped (the card's claims by key are the sorted batch's
tickets; csrc/table_upsert.cu says why); only the TRASH row `cap`, which
the torch rounds write and nothing reads, may differ. dropped counts the
distinct keys left pending after max_rounds. The kernel replaces no
Pallas kernel: the reference's table is XLA jnp (faucet_tpu/core/
table.py). The probe sequence and the round loop (`probe_idx`, `rounds`)
serve core/table.py `lookup` too.

Argument types: the table's keys int32 [cap + 1] (cap a power of two),
its values int32 or int64 [cap + 1] or [cap + 1, w] with w in 1, 4, 8 (at
most three arrays), modes "add" or "max", one per value array. A batch:
khi, klo int64 [N] holding uint32 words, each of vals [N] + its table
array's trailing shape, in its dtype, mask bool [N]. Scan lanes: khi,
klo int64 [N]; idx int64 [>= N]; cnt int64 []; K >= 1; vals the grids of
the table's value arrays after the junction rows, [N] + trailing shape
(any strides); slots None or (ex_slot, en_slot, ex_dist, en_dist int64
[N], exit_ok, entry_ok bool [N]), with the table's first two arrays int32
[cap + 1, 8], "add" then "max", and rows the torch spelling of those rows
(core/scan.py cov_dist8, passed in: kernels/ does not import core/scan).
All on one device, and contiguous on CUDA (the value grids of
`upsert_lanes` excepted).
"""
from __future__ import annotations

import ctypes

import torch

from faucet_tpu_torch import metrics as M
from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core.hashing import hash_pair
from faucet_tpu_torch.kernels import build as KB

MAX_VALS = 3
WIDTHS = (1, 4, 8)
DTYPES = (torch.int32, torch.int64)
MODES = ("add", "max")
EMPTY = 0xFFFFFFFF  # an empty slot's key word, as uint32
EMPTY_I32 = -1   # an empty slot's keys_hi (0xFFFFFFFF as stored)
ROUND_CHUNK = 4  # torch probe rounds between host checks of `pending`
SLOT_DTYPES = (torch.int64,) * 4 + (torch.bool,) * 2

# device -> positions a chunk may hold with its lanes in registers
_threads = {}


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


def segment(v, seg, n: int, mode: str):
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


def dedupe(khi, klo, vals, mask, modes):
    """Sort a batch by key, combine duplicate keys' values; returns the
    sorted keys, combined values, and a representative mask."""
    n = khi.shape[0]
    khi_m = torch.where(mask, khi, EMPTY)
    klo_m = torch.where(mask, klo, EMPTY)
    skey, sidx = torch.sort(u2.sort_key(khi_m, klo_m), stable=True)
    head = torch.ones((n,), dtype=torch.bool, device=khi.device)
    head[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(head, 0) - 1
    combined = tuple(segment(v[sidx], seg, n, mode)
                     for v, mode in zip(vals, modes))
    skhi = khi_m[sidx]
    return skhi, klo_m[sidx], combined, head & (skhi != EMPTY)


def chunk_lanes(idx, total: int, K: int, n_chunks: int = None):
    """(take, live) of each K-lane chunk of a compacted list of `total`
    lanes (n_chunks of them, by default as many as hold the lanes):
    chunk r takes idx[r*K .. r*K + K - 1], the slots past total masked
    (their take is don't-care)."""
    slot = torch.arange(K, device=idx.device)
    if n_chunks is None:
        n_chunks = -(-total // K)
    for r in range(n_chunks):
        take = idx[r * K:(r + 1) * K]
        live = slot < total - r * K
        if total - r * K < K:
            if take.shape[0] < K:
                take = torch.zeros_like(slot)
            take = torch.where(live, take, 0)
        yield take, live


def probe_rounds_plain(tbl, skhi, sklo, cvals, rep, modes,
                       max_rounds: int = 128, shard_bits: int = 0):
    """The probe rounds in torch: dedupe's sorted keys, combined values
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


def upsert_lanes_plain(tbl, idx, cnt, K: int, khi, klo, vals, modes,
                       slots=None, rows=None, max_rounds: int = 128,
                       shard_bits: int = 0):
    """`upsert_lanes` in torch: the lane count read on the host (one
    sync), then per K-lane chunk the lanes' keys and value rows gathered,
    the junction rows built with `rows`, `dedupe` and the torch rounds."""
    total = int(M.fetch(cnt))
    n_chunks = 0
    for take, live in chunk_lanes(idx, total, K):
        cvals = tuple(g[take] for g in vals)
        if slots is not None:
            cvals = tuple(rows(*(f[take] for f in slots))) + cvals
        tbl = probe_rounds_plain(
            tbl, *dedupe(khi[take], klo[take], cvals, live, modes), modes,
            max_rounds, shard_bits)
        n_chunks += 1
    M.count("upsert_lanes", total)
    M.count("upsert_chunks", n_chunks)
    return tbl


def _check_table(tbl, n_vals: int, modes, max_rounds: int,
                 shard_bits: int):
    """Refuse a table, modes or ranges that neither version takes
    (ValueError); returns each value array's width and the table's
    checked tensors, (name, tensor, dtype, shape)."""
    if not len(tbl.vals) == n_vals == len(modes):
        raise ValueError(f"{len(tbl.vals)} table value arrays, {n_vals} "
                         f"batch values, {len(modes)} modes")
    if n_vals > MAX_VALS:
        raise ValueError(f"{n_vals} value arrays: at most {MAX_VALS}")
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
    named = [("keys_hi", tbl.keys_hi, torch.int32, (cap + 1,)),
             ("keys_lo", tbl.keys_lo, torch.int32, (cap + 1,)),
             ("count", tbl.count, torch.int64, ()),
             ("dropped", tbl.dropped, torch.int64, ())]
    widths = []
    for j, tv in enumerate(tbl.vals):
        w = {1: 1, 2: tv.shape[-1]}.get(tv.dim(), 0)
        if tv.dtype not in DTYPES or w not in WIDTHS:
            raise ValueError(f"vals[{j}]: {tv.dtype} {tuple(tv.shape)}; "
                             f"takes int32 or int64 rows of {WIDTHS}")
        widths.append(w)
        named.append((f"vals[{j}]", tv, tv.dtype, (cap + 1,) + tv.shape[1:]))
    return widths, named


def _check_named(named, device):
    """Each (name, tensor, dtype, shape) as named, on `device`."""
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, keys on {device}")


def _rows(tbl, vals, widths, modes):
    """Each value array's (table, lanes' rows, row stride, column stride,
    descriptor) for the kernel, flattened."""
    out = []
    for tv, cv, w, mode in zip(tbl.vals, vals, widths, modes):
        rows = (0, 0, 0) if cv is None else \
            (cv.data_ptr(), cv.stride(0), cv.stride(-1) * (cv.dim() == 2))
        out += [tv.data_ptr(), *rows,
                w | (tv.dtype == torch.int64) << 8 | (mode == "max") << 9]
    return (ctypes.c_int64 * len(out))(*out) if out else None


def _state(dev, positions: int):
    """The kernel's per-position scratch when a chunk of `positions`
    outgrows the lanes the card holds in registers, else None."""
    fit = _threads.get(dev)
    if fit is None:
        with torch.cuda.device(dev):
            fit = _threads[dev] = KB.library().ft_table_upsert_threads()
    if positions <= fit:
        return None
    return torch.empty((positions,), dtype=torch.uint8, device=dev)


def _launch(tbl, khi, klo, mask, idx, total, n, K, vals, widths, modes,
            slots, tally, max_rounds, shard_bits):
    """One launch of the kernel into tbl; the new Table."""
    dev = khi.device
    cap = tbl.capacity
    # the claim words and, last, the grid's pending-block counter: the
    # same allocation as the torch rounds' [cap + 1] (the allocator rounds
    # both up to the same 512-byte block)
    claim = torch.empty((cap + 2,), dtype=torch.int64, device=dev)
    # the new count and dropped: one allocation
    sums = torch.empty((2,), dtype=torch.int64, device=dev)
    state = _state(dev, K)
    ptr = lambda t: None if t is None else t.data_ptr()
    slot_ptrs = None if slots is None else \
        (ctypes.c_int64 * 6)(*(f.data_ptr() for f in slots))
    KB.launch("table_upsert", "upsert_launches", tbl.keys_hi.data_ptr(),
              tbl.keys_lo.data_ptr(), cap, khi.data_ptr(), klo.data_ptr(),
              ptr(mask), ptr(idx), ptr(total), n, K, ptr(state),
              claim.data_ptr(), tbl.count.data_ptr(),
              tbl.dropped.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
              *(ptr(t) for t in tally), shard_bits, max_rounds,
              slot_ptrs, len(widths), _rows(tbl, vals, widths, modes),
              KB.stream_of(khi))
    return tbl._replace(count=sums[0], dropped=sums[1])


def probe_rounds(tbl, khi, klo, vals, mask, modes, max_rounds: int = 128,
                 shard_bits: int = 0):
    """Insert or combine the batch's live lanes into tbl; the new Table."""
    widths, named = _check_table(tbl, len(vals), modes, max_rounds,
                                 shard_bits)
    n = khi.shape[0] if khi.dim() == 1 else -1
    named += [("khi", khi, torch.int64, (n,)),
              ("klo", klo, torch.int64, (n,)),
              ("mask", mask, torch.bool, (n,))]
    named += [(f"vals[{j}]", v, tv.dtype, (n,) + tv.shape[1:])
              for j, (v, tv) in enumerate(zip(vals, tbl.vals))]
    _check_named(named, khi.device)
    if not khi.is_cuda:
        return probe_rounds_plain(tbl, *dedupe(khi, klo, vals, mask, modes),
                                  modes, max_rounds, shard_bits)
    KB.on_card(*((name, t) for name, t, _, _ in named))
    return _launch(tbl, khi, klo, mask, None, None, n, max(n, 1), vals,
                   widths, modes, None, (None, None), max_rounds,
                   shard_bits)


def upsert_lanes(tbl, idx, cnt, K: int, khi, klo, vals, modes, slots=None,
                 rows=None, max_rounds: int = 128, shard_bits: int = 0):
    """Fold the listed scan lanes into tbl, K at a time; the new Table."""
    n_rows = 0 if slots is None else 2
    widths, named = _check_table(tbl, n_rows + len(vals), modes,
                                 max_rounds, shard_bits)
    if isinstance(K, bool) or not isinstance(K, int) or K < 1:
        raise ValueError(f"K {K!r}: lanes a chunk, an int >= 1")
    n = khi.shape[0] if khi.dim() == 1 else -1
    if idx.dim() != 1 or idx.shape[0] < n:
        raise ValueError(f"idx {tuple(idx.shape)}: a list of at least "
                         f"{n} lanes")
    named += [("khi", khi, torch.int64, (n,)),
              ("klo", klo, torch.int64, (n,)),
              ("idx", idx, torch.int64, (idx.shape[0],)),
              ("cnt", cnt, torch.int64, ())]
    if slots is not None:
        if len(slots) != 6 or not callable(rows):
            raise ValueError("slots: the six junction fields, with rows")
        if widths[:2] != [8, 8] or modes[:2] != ("add", "max") or any(
                tv.dtype != torch.int32 for tv in tbl.vals[:2]):
            raise ValueError("junction rows: the table's first two arrays "
                             "int32 [cap + 1, 8], 'add' then 'max'")
        named += [(f"slots[{j}]", f, dt, (n,))
                  for j, (f, dt) in enumerate(zip(slots, SLOT_DTYPES))]
    grids = [(f"vals[{j}]", v, tv.dtype, (n,) + tv.shape[1:])
             for j, (v, tv) in enumerate(zip(vals, tbl.vals[n_rows:]))]
    _check_named(named + grids, khi.device)
    if not khi.is_cuda:
        return upsert_lanes_plain(tbl, idx, cnt, K, khi, klo, vals, modes,
                                  slots, rows, max_rounds, shard_bits)
    KB.on_card(*((name, t) for name, t, _, _ in named))
    m = M.current()
    tally = tuple(m.on_device(key, khi.device)
                  for key in ("upsert_lanes", "upsert_chunks"))
    return _launch(tbl, khi, klo, None, idx, cnt, n, K,
                   (None,) * n_rows + tuple(vals), widths, modes, slots,
                   tally, max_rounds, shard_bits)
