"""Phase-2 device scan: dense junction detection over read batches.

Port of faucet_tpu/core/scan.py, both junction modes and both code
widths, with paired-end junction-pair capture. Per batch:
  1. kmerize -> per-window canonical codes [B, P] (k > 31: four-word codes
     with fingerprint keys, core/wide.py)
  2. window solidity in B; junction-ness from two branch-node probes in E
     per window (junction_detect nodes, k <= 31) or from the 8-way
     extension probe (ext8; the only mode for k > 31)
  3. segment rows into maximal solid runs (cumulative max/min)
  4. junction records (per-slot cov and dist) -> spool or table upsert
  5. every maximal solid-run end -> sink anchor upsert
Wide tables carry the canonical code's four words as one more value,
combined with "max".

Device loops of the reference (lax.cond, fori_loop over a traced round
count) are host loops here; each needs one host sync for its count, but
a single-shard batch's table updates: each is one upsert of every K-lane
round of its compacted lanes (kernels/upsert.py upsert_lanes).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from faucet_tpu_torch import metrics as M
from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import kmer as KM
from faucet_tpu_torch.core import nodes as ND
from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core import wide as WD
from faucet_tpu_torch.core.hashing import pair_key
from faucet_tpu_torch.core.slots import entry_slot, exit_slot
from faucet_tpu_torch.kernels import compact as CP
from faucet_tpu_torch.kernels import upsert as KU
from faucet_tpu_torch.kernels import wide_ext as WX

EMPTY = 0xFFFFFFFF
I32 = torch.int32


class ScanResult(NamedTuple):
    junctions: T.Table
    sinks: T.Table
    n_solid: torch.Tensor      # solid windows in batch
    n_junc_pos: torch.Tensor   # junction-window observations in batch
    jm: torch.Tensor           # [B, P] junction mask
    canon_hi: torch.Tensor     # [B, P]
    canon_lo: torch.Tensor
    jspool: object = None      # JSpool carry when spooling


class JSpool(NamedTuple):
    """Cross-batch junction-update spool (see the reference's docstring).

    Each batch appends its junction lanes; a flush sorts by key,
    pre-combines duplicates and upserts unique representatives. Storage
    is int32 bit patterns; `cnt` is a host int (the append needs it on the
    host anyway, so the port keeps it there)."""
    khi: torch.Tensor  # int32[S]
    klo: torch.Tensor  # int32[S]
    sf: torch.Tensor   # int32[S] ex_slot | en_slot<<3 | exit_ok<<6
                       #          | entry_ok<<7
    dd: torch.Tensor   # int32[S] ex_dist | en_dist<<16
    cnt: int           # valid lanes


def make_jspool(cfg, device=None) -> JSpool:
    """Spool sized so one batch always fits after a flush."""
    need = cfg.batch_reads * cfg.positions_per_read + cfg.scan_update_cap
    S = 1 << (need - 1).bit_length()
    z = lambda: torch.zeros((S,), dtype=I32, device=device)
    return JSpool(khi=z(), klo=z(), sf=z(), dd=z(), cnt=0)


def spool_flush(junctions: T.Table, spool: JSpool, cfg
                ) -> Tuple[T.Table, JSpool]:
    """Drain the spool into the junction table: one key sort groups
    duplicate keys, cov/dist one-hots combine per key, and only unique
    representatives go through table upsert rounds. A span
    `spool_flush` under its caller's (`flush` at a phase end,
    `spool_append` when a batch would not fit), counted in
    `spool_flushes`."""
    with M.span("spool_flush"):
        M.count("spool_flushes")
        S = spool.khi.shape[0]
        valid = torch.arange(S, device=spool.khi.device) < spool.cnt
        khi_m = torch.where(valid, u2.from_i32(spool.khi), EMPTY)
        klo_m = torch.where(valid, u2.from_i32(spool.klo), EMPTY)
        skey, sidx = torch.sort(u2.sort_key(khi_m, klo_m), stable=True)
        skhi, sklo = khi_m[sidx], klo_m[sidx]
        ssf, sdd = u2.from_i32(spool.sf)[sidx], u2.from_i32(spool.dd)[sidx]
        cov8, dist8 = cov_dist8(ssf & 7, (ssf >> 3) & 7, sdd & 0xFFFF,
                                sdd >> 16, (ssf >> 6) & 1 > 0,
                                (ssf >> 7) & 1 > 0)
        head = torch.ones((S,), dtype=torch.bool, device=skey.device)
        head[1:] = skey[1:] != skey[:-1]
        seg = torch.cumsum(head, 0) - 1
        cov8c = KU.segment(cov8, seg, S, "add")
        dist8c = KU.segment(dist8, seg, S, "max")
        rep = head & (skhi != EMPTY)
        K = min(S, cfg.scan_update_cap)

        def fn(tbl, cm, ps):
            return T.upsert(tbl, ps[0], ps[1], (ps[2], ps[3]), cm,
                            modes=("add", "max"), shard_bits=cfg.shard_bits)

        junctions, _ = upsert_rounds(rep, K, (skhi, sklo, cov8c, dist8c), fn,
                                     junctions)
        return junctions, spool._replace(cnt=0)


def _spool_append(junctions: T.Table, spool: JSpool, u: "ScanUpdates",
                  cfg) -> Tuple[T.Table, JSpool]:
    """Append this batch's junction lanes to the spool, flushing first
    when they would not fit. One compaction (kernels/compact.py
    mask_indices) gives the lanes and their count; the spool takes whole
    K-lane rounds from cnt on, the lanes past the live ones EMPTY, exactly
    as the reference's argsort rounds do."""
    jm = u.is_junc.reshape(-1)
    n = jm.shape[0]
    K = min(n, cfg.scan_update_cap)
    idx, cnt = CP.mask_indices(jm, _whole_rounds(n, K))
    total = int(M.fetch(cnt))
    S = spool.khi.shape[0]
    if spool.cnt + total > S - K:
        junctions, spool = spool_flush(junctions, spool, cfg)
    if total == 0:
        return junctions, spool
    flat = lambda a: a.reshape(-1).to(torch.int64)
    sf = (flat(u.ex_slot) | (flat(u.en_slot) << 3)
          | (flat(u.exit_ok) << 6) | (flat(u.entry_ok) << 7))
    dd = (flat(u.ex_dist) & 0xFFFF) | ((flat(u.en_dist) & 0xFFFF) << 16)
    L = _whole_rounds(total, K)
    live = torch.arange(L, device=jm.device) < total
    take = torch.where(live, idx[:L], 0)
    off = spool.cnt
    for dst, src, fill in ((spool.khi, flat(u.key_hi), EMPTY),
                           (spool.klo, flat(u.key_lo), EMPTY),
                           (spool.sf, sf, 0), (spool.dd, dd, 0)):
        dst[off:off + L] = u2.to_i32(torch.where(live, src[take], fill))
    return junctions, spool._replace(cnt=off + total)


def _shift(a, by: int, fill):
    """a shifted along dim 1 by `by` (+1: right, -1: left), new cells
    filled — the reference's jnp.pad of a [:, :-1] / [:, 1:] slice."""
    col = torch.full_like(a[:, :1], fill)
    if by > 0:
        return torch.cat([col, a[:, :-1]], dim=1)
    return torch.cat([a[:, 1:], col], dim=1)


def _rcum(fn, a):
    """Reverse cumulative op along dim 1."""
    return torch.flip(fn(torch.flip(a, [1]), dim=1).values, [1])


def _row_runs(solid, is_junc):
    """Per-row maximal solid-run bookkeeping, fully vectorized.

    Returns (run_start_idx, run_end_idx, prev_junc_idx, next_junc_idx,
    run_junc_total, start_m, end_m); *_junc_idx are -1 when absent,
    strictly before/after the position within its run. Same packed
    cummax/cummin formulation as the reference (bit-identical); packed in
    int64, so the reference's P < 2**15 int32 bound does not apply."""
    B, P = solid.shape
    start_m = solid & ~_shift(solid, 1, False)
    end_m = solid & ~_shift(solid, -1, False)
    pos = torch.arange(P, device=solid.device).expand(B, P)
    BIG = P  # > any index; stands in for +inf
    cmax = lambda a: torch.cummax(a, dim=1).values

    rs = cmax(torch.where(start_m, pos, 0))
    jmax_excl = _shift(cmax(torch.where(is_junc, pos, -1)), 1, -1)
    pj = torch.where(jmax_excl >= rs, jmax_excl, -1)
    ji = is_junc.to(torch.int64)
    cj = torch.cumsum(ji, dim=1)
    VS = 2 * P + 2   # packed values cj*2+junc < VS
    fw = cmax(torch.where(start_m | (pos == 0), (pos + 1) * VS + cj * 2 + ji,
                          0))
    at_rs = fw % VS
    cnt_incl = cj - at_rs // 2 + at_rs % 2

    emin = _rcum(torch.cummin, torch.where(end_m, pos, BIG))
    re = torch.where(emin < BIG, emin, 0)
    jmin_excl = _shift(_rcum(torch.cummin, torch.where(is_junc, pos, BIG)),
                       -1, P)
    emin_excl = _shift(emin, -1, P)
    nj = torch.where((~end_m) & (jmin_excl <= emin_excl)
                     & (jmin_excl < BIG), jmin_excl, -1)
    VS2 = P + 1      # cnt_incl <= P
    bw = _rcum(torch.cummax, torch.where(end_m, (BIG - pos) * VS2 + cnt_incl,
                                         0))
    tot = torch.where(bw > 0, bw % VS2, 0)
    return rs, re, pj, nj, tot, start_m, end_m


class ScanUpdates(NamedTuple):
    """Per-window update grids produced by scan_core (the reference's; its
    [B, P, 4] wide word grid is `words` here, None for narrow codes)."""
    is_junc: torch.Tensor    # [B, P] junction-window mask
    ex_slot: torch.Tensor    # [B, P] exit slot (0..7)
    en_slot: torch.Tensor    # [B, P] entry slot (0..7)
    ex_dist: torch.Tensor    # [B, P] bases to next junction/run end
    en_dist: torch.Tensor    # [B, P] bases from prev junction/start
    exit_ok: torch.Tensor    # [B, P] bool exit-slot traversal observed
    entry_ok: torch.Tensor   # [B, P] bool entry-slot traversal observed
    sink_pos: torch.Tensor   # [B, P] sink-anchor mask
    sink_cov: torch.Tensor   # [B, P]
    key_hi: torch.Tensor     # [B, P] table keys
    key_lo: torch.Tensor
    jm: torch.Tensor         # alias of is_junc
    canon_hi: torch.Tensor   # [B, P]
    canon_lo: torch.Tensor
    n_solid: torch.Tensor
    n_junc_pos: torch.Tensor
    words: torch.Tensor = None  # [B, P, 4] canonical code words (wide)


def cov_dist8(ex_slot, en_slot, ex_dist, en_dist, exit_ok, entry_ok):
    """Expand slim per-lane slot/dist/flag fields to the (cov8, dist8)
    junction-record update rows, int32. (dist8 stays int32 in the port;
    it becomes uint16 only at the checkpoint boundary.)"""
    sl8 = torch.arange(8, device=ex_slot.device)
    ex_oh = (ex_slot[..., None] == sl8) & exit_ok[..., None]
    en_oh = (en_slot[..., None] == sl8) & entry_ok[..., None]
    cov8 = (ex_oh.to(I32) + en_oh.to(I32))
    dist8 = torch.maximum(ex_oh * ex_dist[..., None],
                          en_oh * en_dist[..., None]).to(I32)
    return cov8, dist8


def _whole_rounds(n: int, K: int) -> int:
    """n rounded up to whole K-lane rounds."""
    return -(-n // K) * K if n else 0


def compact_rounds(mask, K: int, payloads, fn, state, compact, sync=None):
    """The round loop of upsert_rounds: ONE call of `compact` (the
    kernels/compact.py mask_indices contract) lists the live lanes in lane
    order and counts them (the one host sync); round r folds lanes
    r*K .. r*K + K - 1 of that list. Round contents equal the reference's
    stable-argsort rounds: both take live lanes K at a time in lane
    order. `sync` maps the round count (the sharded scan takes the max
    over its ranks, so every rank issues the same collectives; rounds
    past this rank's own carry no live lane). Returns (state, live
    lanes)."""
    idx, cnt = compact(mask, _whole_rounds(mask.shape[0], K))
    total = int(M.fetch(cnt))
    rounds = -(-total // K) if total else 0
    if sync is not None:
        rounds = sync(rounds)
    for take, cm in KU.chunk_lanes(idx, total, K, rounds):
        state = fn(state, cm, tuple(p[take] for p in payloads))
    return state, total


def upsert_rounds(mask, K: int, payloads, fn, state, sync=None):
    """Fold every True lane of a sparse update grid into `state`, K
    compacted lanes per round, keeping lane order. The lanes come from one
    launch of the stream-compaction kernel (kernels/compact.py
    mask_indices, looked up at call time; its plain version on CPU
    tensors); their count is fetched to the host (one sync). `sync`: as
    compact_rounds'."""
    return compact_rounds(mask, K, payloads, fn, state, CP.mask_indices,
                          sync=sync)


def scan_batch(cascade: BL.Cascade, junctions: T.Table, sinks: T.Table,
               bases, lens, cfg, node_cascade: BL.Cascade = None,
               window_solid=None, jspool: JSpool = None) -> ScanResult:
    """Single-shard scan. window_solid: optional precomputed [B, P]
    B-membership of the windows (single-pass streaming reuses the insert
    pass's flags instead of re-probing). jspool: junction lanes append to
    the spool instead of upserting per batch (narrow keys only); the
    caller flushes. Wide tables take the code words as a last value."""
    solid_fn = lambda khi, klo, m: BL.cascade_solid(cascade, khi, klo, m,
                                                    cfg)
    node_fn = None
    if node_cascade is not None and cfg.use_node_junctions:
        ncfg = cfg.node_view()
        node_fn = lambda khi, klo, m: BL.cascade_solid(node_cascade, khi,
                                                       klo, m, ncfg)
    u = scan_core(solid_fn, bases, lens, cfg, node_solid_fn=node_fn,
                  window_solid=window_solid)
    flat = lambda a: a.reshape(-1)
    N = u.is_junc.numel()
    K = min(N, cfg.scan_update_cap)
    wcol = () if u.words is None else (u.words.reshape(-1, WD.NW),)
    wmode = ("max",) * len(wcol)

    def update(tbl, mask, vals, modes, slots=None):
        # the lanes as the compaction lists them, every K-lane chunk of
        # the update in one upsert (one launch on the card, no host read)
        idx, cnt = CP.mask_indices(flat(mask), _whole_rounds(N, K))
        with M.span("upsert"):
            return KU.upsert_lanes(
                tbl, idx, cnt, K, flat(u.key_hi), flat(u.key_lo), vals,
                modes, slots=slots, rows=cov_dist8,
                shard_bits=cfg.shard_bits)

    if jspool is not None and not wcol:
        with M.span("spool_append"):
            junctions, jspool = _spool_append(junctions, jspool, u, cfg)
    else:
        junctions = update(
            junctions, u.is_junc, wcol, ("add", "max") + wmode,
            slots=tuple(flat(f) for f in (u.ex_slot, u.en_slot, u.ex_dist,
                                          u.en_dist, u.exit_ok,
                                          u.entry_ok)))
    sinks = update(sinks, u.sink_pos, (flat(u.sink_cov),) + wcol,
                   ("add",) + wmode)
    return ScanResult(
        junctions=junctions, sinks=sinks, n_solid=u.n_solid,
        n_junc_pos=u.n_junc_pos, jm=u.jm, canon_hi=u.canon_hi,
        canon_lo=u.canon_lo, jspool=jspool)


def scan_core(solid_fn, bases, lens, cfg, node_solid_fn=None,
              window_solid=None) -> ScanUpdates:
    """Scan with injected oracles: solid_fn answers membership in B,
    node_solid_fn (junction_detect nodes) membership of tagged branch-node
    keys in E. Without it, junctions come from the 8-way extension probe.
    For k > 31 the window keys are fingerprints of four-word codes; all
    that follows (key, slot, mask) is width-agnostic."""
    k = cfg.size_kmer
    nodes = node_solid_fn is not None and cfg.use_node_junctions
    if k <= 31:
        view = KM.kmerize(bases, lens, k)
        key_hi, key_lo = view.canon_hi, view.canon_lo
        cisf, valid = view.canon_is_fwd, view.valid
        other_hi, other_lo = u2.select(cisf, view.rc_hi, view.rc_lo,
                                       view.fwd_hi, view.fwd_lo)
        words = None

        def ext_keys():
            return KM.slot_ext_pairs(key_hi, key_lo, other_hi, other_lo, k)
    else:
        if nodes:
            raise ValueError("branch-node junctions need k <= 31")
        wv = WD.kmerize_wide(bases, lens, k)
        key_hi, key_lo = wv.key_hi, wv.key_lo
        cisf, valid = wv.canon_is_fwd, wv.valid
        other = WD.wselect(cisf, wv.rc, wv.fwd)
        words = wv.canon.permute(1, 2, 0)  # [B, P, 4]

        def ext_keys():
            with M.span("ext_keys"):
                return WX.slot_ext_keys(wv.canon, other, k)
    B, P = key_hi.shape
    solid = (window_solid & valid) if window_solid is not None \
        else solid_fn(key_hi, key_lo, valid)

    # neighbor read bases (codes) just outside each window
    L = bases.shape[1]
    nb = torch.cat([bases[:, k:], torch.full((B, max(0, P - (L - k))), 4,
                                             dtype=bases.dtype,
                                             device=bases.device)],
                   dim=1)[:, :P]
    pb = _shift(bases[:, :P], 1, 4)
    ex_slot = exit_slot(cisf, torch.clamp(nb, max=3).to(torch.int64))
    en_slot = entry_slot(cisf, torch.clamp(pb, max=3).to(torch.int64))

    if nodes:
        with M.span("node_probe"):
            rk_hi, rk_lo, lk_hi, lk_lo = ND.probe_keys(key_hi, key_lo,
                                                       other_hi, other_lo, k)
            # one probe call for both branch queries: one kernel launch
            qhi = torch.stack([rk_hi, lk_hi])
            qlo = torch.stack([rk_lo, lk_lo])
            branch = node_solid_fn(qhi, qlo, solid.expand(2, B, P))
        is_junc = solid & (branch[0] | branch[1])
    else:
        # The read itself answers 2 of the 8 extension probes: the slot the
        # read exits a window by IS the next window's k-mer, the entry slot
        # the previous window's. Those lanes are masked off the probe (the
        # kernel skips masked lanes) and filled from the neighbouring
        # windows' own solidity: bit-identical to probing them.
        sl8 = torch.arange(8, device=bases.device)
        ex_oh_b = (ex_slot[..., None] == sl8) \
            & (valid & _shift(valid, -1, False))[..., None]
        en_oh_b = (en_slot[..., None] == sl8) \
            & (valid & _shift(valid, 1, False))[..., None]
        known = ex_oh_b | en_oh_b
        fill = ((ex_oh_b & _shift(solid, -1, False)[..., None])
                | (en_oh_b & _shift(solid, 1, False)[..., None])) \
            & solid[..., None]
        ehi, elo = ext_keys()
        # one [B, P, 8] query: one kernel launch
        probed = solid_fn(ehi, elo, solid[..., None] & ~known)
        ext_solid = torch.where(known, fill, probed)
        is_junc = solid & ((ext_solid[..., :4].sum(-1) >= 2)
                           | (ext_solid[..., 4:].sum(-1) >= 2))

    rs, re, pj, nj, tot, start_m, end_m = _row_runs(solid, is_junc)
    pos = torch.arange(P, device=bases.device)[None, :]

    exit_ok = is_junc & ~end_m
    entry_ok = is_junc & ~start_m
    ex_dist = torch.where(nj >= 0, nj, re) - pos
    en_dist = pos - torch.where(pj >= 0, pj, rs)

    # EVERY maximal-solid-run end is a sink/cap anchor
    sink_pos = solid & (start_m | end_m)
    sink_cov = start_m.to(I32) + end_m.to(I32)
    return ScanUpdates(
        is_junc=is_junc, ex_slot=ex_slot, en_slot=en_slot, ex_dist=ex_dist,
        en_dist=en_dist, exit_ok=exit_ok, entry_ok=entry_ok,
        sink_pos=sink_pos, sink_cov=sink_cov, key_hi=key_hi, key_lo=key_lo,
        jm=is_junc, canon_hi=key_hi, canon_lo=key_lo,
        n_solid=solid.sum(), n_junc_pos=is_junc.sum(), words=words)


J_CHUNK = 32  # junction lanes per pair-capture tile side (not a cap: tiles
#   iterate until every distinct junction of every mate is covered)
_EMPTY_KEY = (1 << 63) - 1  # u2.sort_key(EMPTY, EMPTY): sorts last


def _row_junctions(jm, chi, clo):
    """All distinct junction canon codes per row, compacted to the front.

    Returns (hi, lo, valid, count): hi/lo/valid [B, P] with the valid
    lanes contiguous from column 0, count [B] distinct junctions per row.
    The reference's 2-key sort along rows is one row-wise sort of the
    packed key (u2.sort_key keeps the unsigned order, EMPTY last)."""
    B = jm.shape[0]
    key, _ = torch.sort(torch.where(jm, u2.sort_key(chi, clo), _EMPTY_KEY),
                        dim=1)
    first = torch.ones_like(jm)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    valid = first & (key != _EMPTY_KEY)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    hi, lo = u2.from_sort_key(torch.gather(key, 1, order))
    return hi, lo, torch.gather(valid, 1, order), valid.sum(dim=1)


def capture_pairs(pairs: T.Table, res1: ScanResult, res2: ScanResult,
                  cfg=None) -> T.Table:
    """Record junction co-occurrences across mate pairs (port of the
    reference's capture_pairs; lossless).

    res1/res2 are the ScanResults of the two mate batches (row-aligned).
    Each row's distinct junction sets are crossed in J_CHUNK x J_CHUNK
    tiles, keyed by the order-independent pair hash and counted in the
    pair table (in place). The reference's device loop over the tiles is
    a host loop: one sync fetches both mates' densest row counts."""
    ahi, alo, av, na = _row_junctions(res1.jm, res1.canon_hi,
                                      res1.canon_lo)
    bhi, blo, bv, nb = _row_junctions(res2.jm, res2.canon_hi,
                                      res2.canon_lo)
    J = J_CHUNK

    def padJ(x, fill):
        padn = (-x.shape[1]) % J
        if not padn:
            return x
        return torch.cat([x, torch.full((x.shape[0], padn), fill,
                                        dtype=x.dtype, device=x.device)],
                         dim=1)

    ahi, alo, av = padJ(ahi, EMPTY), padJ(alo, EMPTY), padJ(av, False)
    bhi, blo, bv = padJ(bhi, EMPTY), padJ(blo, EMPTY), padJ(bv, False)
    max_a, max_b = M.fetch(torch.stack([na.max(), nb.max()])).tolist()
    ra, rb = -(-max_a // J), -(-max_b // J)
    shard_bits = 0 if cfg is None else cfg.shard_bits
    sl = lambda x, t: x[:, t * J:(t + 1) * J]
    for i in range(ra * rb):
        ta, tb = divmod(i, rb)
        khi, klo = pair_key(sl(ahi, ta)[:, :, None], sl(alo, ta)[:, :, None],
                            sl(bhi, tb)[:, None, :], sl(blo, tb)[:, None, :])
        mask = sl(av, ta)[:, :, None] & sl(bv, tb)[:, None, :]
        n = khi.numel()
        pairs = T.upsert(pairs, khi.reshape(n), klo.reshape(n),
                         (torch.ones((n,), dtype=I32, device=khi.device),),
                         mask.reshape(n), modes=("add",),
                         shard_bits=shard_bits)
    return pairs


def load_batch_s(cascade: BL.Cascade, bases, lens, cfg):
    """Phase-1 cascade load of every valid window of the batch, and the
    per-window solidity grid."""
    if cfg.size_kmer <= 31:
        view = KM.kmerize(bases, lens, cfg.size_kmer)
        khi, klo, valid = view.canon_hi, view.canon_lo, view.valid
    else:
        wv = WD.kmerize_wide(bases, lens, cfg.size_kmer)
        khi, klo, valid = wv.key_hi, wv.key_lo, wv.valid
    cascade, _new_b, solid = BL.cascade_insert_nbs(
        cascade, khi.reshape(-1), klo.reshape(-1), valid.reshape(-1), cfg)
    return cascade, solid.reshape(khi.shape)


def load_batch_nodes_s(cascade: BL.Cascade, node_cascade: BL.Cascade,
                       bases, lens, cfg):
    """Phase-1 load + branch-node cascade maintenance; returns (cascade,
    node_cascade, n_new_b, the per-window B-solidity grid, which
    single-pass streaming hands to the scan in place of its own window
    probe). Each k-mer newly promoted into B inserts its two endpoint
    keys into the node cascade D -> E."""
    view = KM.kmerize(bases, lens, cfg.size_kmer)
    cascade, new_b, solid = BL.cascade_insert_nbs(
        cascade, view.canon_hi.reshape(-1), view.canon_lo.reshape(-1),
        view.valid.reshape(-1), cfg)
    other_hi, other_lo = u2.select(view.canon_is_fwd, view.rc_hi,
                                   view.rc_lo, view.fwd_hi, view.fwd_lo)
    with M.span("node_insert"):
        pk_hi, pk_lo, sk_hi, sk_lo = ND.endpoint_keys(
            view.canon_hi, view.canon_lo, other_hi, other_lo, cfg.size_kmer)
        nhi = torch.cat([pk_hi.reshape(-1), sk_hi.reshape(-1)])
        nlo = torch.cat([pk_lo.reshape(-1), sk_lo.reshape(-1)])
        M.count("node_keys", nhi.shape[0])
        node_cascade, _, _ = BL.cascade_insert_nbs(
            node_cascade, nhi, nlo, torch.cat([new_b, new_b]),
            cfg.node_view(), sparse=True)
    return (cascade, node_cascade, new_b.sum(),
            solid.reshape(view.canon_hi.shape))
