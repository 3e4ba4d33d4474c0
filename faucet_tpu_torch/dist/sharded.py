"""Hash-range-sharded stream phases, one process per shard (port of
faucet_tpu/dist/sharded.py).

The Bloom cascade and the junction, sink and pair tables are partitioned
by the top bits of each k-mer's h1 hash. Single-device addressing is
already owner-prefixed (core/bloom, core/table `shard_bits`), so the
global arrays split along axis 0 into exactly the per-shard structures:
every rank holds `cfg.local_shard()` state (capacities global / n_shards,
hash counts pinned, addressing unprefixed), and the ranks' arrays
concatenated in rank order ARE the single-device layout (`gather_table`,
`gather_cascade`). The stream phases differ from the local ones only in
routing (dist/route.py):

  load:  kmerize this rank's rows -> all_to_all k-mers to their owner ->
         local cascade insert (branch-node endpoint keys of new-B k-mers
         route on to THEIR owners, nested in the outer round)
  scan:  solidity and node probes route to the owner and answers route
         back; junction/sink updates route to the owner and upsert there

Every rank takes rows [r*B/S, (r+1)*B/S) of each batch (the reference's
P("shard") row split); with several hosts, each host feeds its own reads
in batches of batch_reads / hosts rows and its ranks split those.

The graph build walks frontier lanes split over the ranks with routed
probes (dist/swalk.py, k <= 31 with route_walks), or, otherwise, on the
gathered global arrays as the single-device builder does. Every rank then
holds the same graph; cleaning runs on each, and only global rank 0
writes outputs (cli.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import kmer as KM
from faucet_tpu_torch.core import nodes as ND
from faucet_tpu_torch.core import scan as SC
from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core import wide as WD
from faucet_tpu_torch.core.hashing import hash_pair, pair_key
from faucet_tpu_torch.dist import route as R
from faucet_tpu_torch.dist.mesh import Mesh

I32 = torch.int32
I64 = torch.int64


def _owner(khi, klo, shard_bits: int):
    h1, _ = hash_pair(khi, klo)
    return h1 >> (32 - shard_bits)


def _cap_for(n: int, n_shards: int, factor: float = 2.0) -> int:
    """Per-peer bucket capacity for n items over n_shards."""
    base = -(-n // n_shards)
    return max(64, int(base * factor))


# ---- the per-rank shard bodies --------------------------------------------

def _load_local(mesh: Mesh, cascade: BL.Cascade, bases, lens, *, cfg_local,
                n_shards, shard_bits):
    k = cfg_local.size_kmer
    if k <= 31:
        view = KM.kmerize(bases, lens, k)
        khi, klo, mask = view.canon_hi, view.canon_lo, view.valid
    else:
        wv = WD.kmerize_wide(bases, lens, k)
        khi, klo, mask = wv.key_hi, wv.key_lo, wv.valid
    khi, klo, mask = khi.reshape(-1), klo.reshape(-1), mask.reshape(-1)
    return R.route_consume(
        mesh, {"hi": khi, "lo": klo}, _owner(khi, klo, shard_bits), mask,
        n_shards, _cap_for(khi.shape[0], n_shards),
        lambda c, recv, rmask: BL.cascade_insert(
            c, recv["hi"], recv["lo"], rmask, cfg_local),
        cascade)


def _load_local_nodes(mesh: Mesh, cascade: BL.Cascade,
                      node_cascade: BL.Cascade, bases, lens, *, cfg_local,
                      n_shards, shard_bits):
    """Load + branch-node cascade: k-mers route to their owner with their
    endpoint keys as payload; the owner's insert reports new-B promotions,
    whose endpoint keys route on to THEIR owners for the D -> E insert
    (a nested lossless route inside each outer round)."""
    k = cfg_local.size_kmer
    view = KM.kmerize(bases, lens, k)
    other_hi, other_lo = u2.select(view.canon_is_fwd, view.rc_hi,
                                   view.rc_lo, view.fwd_hi, view.fwd_lo)
    pk_hi, pk_lo, sk_hi, sk_lo = ND.endpoint_keys(
        view.canon_hi, view.canon_lo, other_hi, other_lo, k)
    khi, klo = view.canon_hi.reshape(-1), view.canon_lo.reshape(-1)
    ncfg = cfg_local.node_view()

    def consume(state, recv, rmask):
        cascade, node_cascade, unsent_inner = state
        cascade, new_b = BL.cascade_insert_nb(
            cascade, recv["hi"], recv["lo"], rmask, cfg_local)
        nhi = torch.cat([recv["pk_hi"], recv["sk_hi"]])
        nlo = torch.cat([recv["pk_lo"], recv["sk_lo"]])
        nmask = torch.cat([new_b & rmask, new_b & rmask])
        node_cascade, un = R.route_consume(
            mesh, {"hi": nhi, "lo": nlo}, _owner(nhi, nlo, shard_bits),
            nmask, n_shards, _cap_for(nhi.shape[0], n_shards),
            lambda nc, nrecv, nrmask: BL.cascade_insert(
                nc, nrecv["hi"], nrecv["lo"], nrmask, ncfg, sparse=True),
            node_cascade)
        return cascade, node_cascade, unsent_inner + un

    (cascade, node_cascade, un_inner), unsent = R.route_consume(
        mesh, {"hi": khi, "lo": klo, "pk_hi": pk_hi.reshape(-1),
               "pk_lo": pk_lo.reshape(-1), "sk_hi": sk_hi.reshape(-1),
               "sk_lo": sk_lo.reshape(-1)},
        _owner(khi, klo, shard_bits), view.valid.reshape(-1), n_shards,
        _cap_for(khi.shape[0], n_shards), consume,
        (cascade, node_cascade, torch.zeros((), dtype=I64,
                                            device=khi.device)))
    return cascade, node_cascade, unsent + un_inner


def routed_query_fn(mesh: Mesh, n_shards: int, shard_bits: int, answer):
    """A (khi, klo, mask) -> bool oracle whose lanes are answered by their
    owners: answer(hi, lo, mask) runs on the received lanes there."""
    def fn(khi, klo, mask):
        shape = khi.shape
        fhi, flo = khi.reshape(-1), klo.reshape(-1)
        fm = torch.broadcast_to(mask, shape).reshape(-1)
        got, _ = R.route_query(
            mesh, {"hi": fhi, "lo": flo}, _owner(fhi, flo, shard_bits), fm,
            n_shards, _cap_for(fhi.shape[0], n_shards),
            lambda recv, rmask: answer(recv["hi"], recv["lo"], rmask))
        return (got > 0).reshape(shape)

    return fn


def _scan_local(mesh: Mesh, cascade: BL.Cascade, junctions: T.Table,
                sinks: T.Table, bases, lens, node_cascade=None, *, cfg,
                cfg_local, n_shards, shard_bits):
    solid_fn = routed_query_fn(
        mesh, n_shards, shard_bits,
        lambda h, l, m: BL.cascade_solid(cascade, h, l, m, cfg_local))
    node_fn = None
    if node_cascade is not None and cfg.use_node_junctions:
        ncfg = cfg_local.node_view()
        node_fn = routed_query_fn(
            mesh, n_shards, shard_bits,
            lambda h, l, m: BL.cascade_solid(node_cascade, h, l, m, ncfg))
    u = SC.scan_core(solid_fn, bases, lens, cfg, node_solid_fn=node_fn)

    # junction/sink updates: compaction rounds (lossless, as the local
    # path) with per-round owner routing at full-size per-peer buckets;
    # the round count is a max over the ranks, so every rank issues the
    # same collectives
    flat = lambda a: a.reshape(-1)
    K = min(u.is_junc.numel(), cfg.scan_update_cap)
    wide = u.words is not None
    wcol = (u.words.reshape(-1, WD.NW),) if wide else ()
    wmode = ("max",) if wide else ()
    sync = mesh.pmax

    def jfn(st, cm, ps):
        tbl, dr = st
        jhi, jlo, exs, ens, exd, end_, exo, eno = ps[:8]
        # the slim slot/dist/flag fields travel packed (slots and flags in
        # one word, the two dists in another) and expand to one-hot
        # update rows at the owner
        jp = {"hi": jhi, "lo": jlo,
              "sf": (exs.to(I64) | (ens.to(I64) << 3) | (exo.to(I64) << 6)
                     | (eno.to(I64) << 7)),
              "dd": ((exd.to(I64) & 0xFFFF)
                     | ((end_.to(I64) & 0xFFFF) << 16))}
        if wide:
            jp["words"] = ps[8]

        def consume(t, recv, rmask):
            sf, dd = recv["sf"], recv["dd"]
            cov8, dist8 = SC.cov_dist8(sf & 7, (sf >> 3) & 7, dd & 0xFFFF,
                                       dd >> 16, (sf >> 6) & 1 > 0,
                                       (sf >> 7) & 1 > 0)
            return T.upsert(t, recv["hi"], recv["lo"],
                            (cov8, dist8) + ((recv["words"],) if wide
                                             else ()),
                            rmask, modes=("add", "max") + wmode)

        tbl, un = R.route_consume(mesh, jp, _owner(jhi, jlo, shard_bits),
                                  cm, n_shards, K, consume, tbl)
        return tbl, dr + un

    zero = torch.zeros((), dtype=I64, device=bases.device)
    (junctions, jdrop), _ = SC.upsert_rounds(
        flat(u.is_junc), K,
        (flat(u.key_hi), flat(u.key_lo), flat(u.ex_slot), flat(u.en_slot),
         flat(u.ex_dist), flat(u.en_dist), flat(u.exit_ok),
         flat(u.entry_ok)) + wcol, jfn, (junctions, zero), sync=sync)

    def sfn(st, cm, ps):
        tbl, dr = st
        sp = {"hi": ps[0], "lo": ps[1], "cov": ps[2]}
        if wide:
            sp["words"] = ps[3]
        tbl, un = R.route_consume(
            mesh, sp, _owner(ps[0], ps[1], shard_bits), cm, n_shards, K,
            lambda t, recv, rmask: T.upsert(
                t, recv["hi"], recv["lo"],
                (recv["cov"],) + ((recv["words"],) if wide else ()),
                rmask, modes=("add",) + wmode),
            tbl)
        return tbl, dr + un

    (sinks, sdrop), _ = SC.upsert_rounds(
        flat(u.sink_pos), K,
        (flat(u.key_hi), flat(u.key_lo), flat(u.sink_cov)) + wcol, sfn,
        (sinks, zero), sync=sync)
    return (junctions, sinks, u.n_solid, u.n_junc_pos, u.jm, u.canon_hi,
            u.canon_lo, jdrop + sdrop)


def _pairs_local(mesh: Mesh, pairs: T.Table, jm1, chi1, clo1, jm2, chi2,
                 clo2, *, n_shards, shard_bits):
    """Paired-end junction pair capture: each rank's mate rows contribute
    cross-product pair keys, routed losslessly to the pair-hash owner and
    counted in its pair-table slice (tiles as core/scan.capture_pairs)."""
    ahi, alo, av, na = SC._row_junctions(jm1, chi1, clo1)
    bhi, blo, bv, nb = SC._row_junctions(jm2, chi2, clo2)
    J = SC.J_CHUNK
    B = ahi.shape[0]

    def padJ(x, fill):
        padn = (-x.shape[1]) % J
        if not padn:
            return x
        return torch.cat([x, torch.full((B, padn), fill, dtype=x.dtype,
                                        device=x.device)], dim=1)

    ahi, alo, av = padJ(ahi, SC.EMPTY), padJ(alo, SC.EMPTY), padJ(av, False)
    bhi, blo, bv = padJ(bhi, SC.EMPTY), padJ(blo, SC.EMPTY), padJ(bv, False)
    # every rank runs the same (lossless) tile count
    local = torch.stack([na.max(), nb.max()]).tolist()
    ra, rb = (-(-m // J) for m in mesh.pmax_many(local))
    cap = _cap_for(B * J * J, n_shards)
    sl = lambda x, t: x[:, t * J:(t + 1) * J]
    unsent = torch.zeros((), dtype=I64, device=jm1.device)
    for i in range(ra * rb):
        ta, tb = divmod(i, max(rb, 1))
        khi, klo = pair_key(sl(ahi, ta)[:, :, None], sl(alo, ta)[:, :, None],
                            sl(bhi, tb)[:, None, :], sl(blo, tb)[:, None, :])
        mask = (sl(av, ta)[:, :, None] & sl(bv, tb)[:, None, :]).reshape(-1)
        khi, klo = khi.reshape(-1), klo.reshape(-1)
        pairs, u = R.route_consume(
            mesh, {"hi": khi, "lo": klo}, _owner(khi, klo, shard_bits), mask,
            n_shards, cap,
            lambda t, recv, rmask: T.upsert(
                t, recv["hi"], recv["lo"],
                (torch.ones(rmask.shape, dtype=I32, device=rmask.device),),
                rmask, modes=("add",)),
            pairs)
        unsent = unsent + u
    return pairs, unsent


# ---- global arrays <-> rank slices -----------------------------------------

def gather_table(mesh: Mesh, tbl: T.Table) -> T.Table:
    """The global table (every rank's rows in rank order, one TRASH row)
    on this rank's device, its counters one per rank ([n_shards], as the
    reference's sharded tables and checkpoints keep them); collective."""
    cap = tbl.capacity

    def cat(a, fill):
        g = mesh.fetch(a[:cap])
        return torch.cat([g, torch.full((1,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])

    counters = mesh.fetch(torch.stack([tbl.count, tbl.dropped])[None])
    return T.Table(keys_hi=cat(tbl.keys_hi, T.EMPTY_I32),
                   keys_lo=cat(tbl.keys_lo, T.EMPTY_I32),
                   vals=tuple(cat(v, 0) for v in tbl.vals),
                   count=counters[:, 0], dropped=counters[:, 1])


def gather_cascade(mesh: Mesh, c: BL.Cascade) -> BL.Cascade:
    return BL.Cascade(a_bloom=BL.Bloom(mesh.fetch(c.a_bloom.words)),
                      b_bloom=BL.Bloom(mesh.fetch(c.b_bloom.words)),
                      a_table=gather_table(mesh, c.a_table),
                      b_table=gather_table(mesh, c.b_table))


def local_table(tbl: T.Table, rank: int, n_shards: int, device) -> T.Table:
    """This rank's slice of a global table (a checkpoint's), TRASH row
    appended; its count is its occupied rows, the whole dropped count
    goes to rank 0."""
    cap = tbl.capacity // n_shards
    sl = lambda a: a[rank * cap:(rank + 1) * cap]

    def piece(a, fill):
        return torch.cat([sl(a), torch.full((1,) + a.shape[1:], fill,
                                            dtype=a.dtype,
                                            device=a.device)]).to(device)

    keys_hi = piece(tbl.keys_hi, T.EMPTY_I32)
    count = (keys_hi[:cap] != T.EMPTY_I32).sum().to(I64)
    dropped = tbl.dropped.sum().to(device) if rank == 0 \
        else torch.zeros_like(count)
    return T.Table(keys_hi=keys_hi, keys_lo=piece(tbl.keys_lo, T.EMPTY_I32),
                   vals=tuple(piece(v, 0) for v in tbl.vals), count=count,
                   dropped=dropped.to(I64))


def local_cascade(c: BL.Cascade, rank: int, n_shards: int,
                  device) -> BL.Cascade:
    def words(w):
        n = w.shape[0] // n_shards
        return BL.Bloom(w[rank * n:(rank + 1) * n].to(device))

    return BL.Cascade(a_bloom=words(c.a_bloom.words),
                      b_bloom=words(c.b_bloom.words),
                      a_table=local_table(c.a_table, rank, n_shards, device),
                      b_table=local_table(c.b_table, rank, n_shards, device))


# ---- the per-rank pipeline -------------------------------------------------

class ShardedPipeline:
    """One rank of the sharded pipeline: sharded stream phases + the host
    build/clean phases over the graph every rank builds alike.

    Mirrors pipeline.Pipeline's surface (load_*, scan_*, scan_paired*,
    run_streaming*, pair_counts, build, clean_graph, run_file_mode). Every
    rank of the mesh makes the same calls in the same order. With several
    hosts (mesh.hosts), each host's ranks see that host's reads, in
    batches of batch_reads / hosts rows (`feed_cfg`)."""

    def __init__(self, cfg, mesh: Mesh, metrics=None):
        from faucet_tpu_torch.metrics import Metrics

        if cfg.n_shards != mesh.n_shards:
            raise ValueError(f"cfg.n_shards {cfg.n_shards} != mesh "
                             f"{mesh.n_shards}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.metrics = metrics or Metrics(cfg.metrics_file)
        self.cfg_local = cfg.local_shard()
        self.feed_cfg = (dataclasses.replace(
            cfg, batch_reads=max(1, cfg.batch_reads // mesh.hosts))
            if mesh.hosts > 1 else cfg)
        cl, dev = self.cfg_local, self.device
        self._kw = dict(n_shards=cfg.n_shards, shard_bits=cfg.shard_bits)
        self.cascade = BL.make_cascade(cl, dev)
        self.node_cascade = (BL.make_cascade(cl.node_view(), dev)
                             if cfg.use_node_junctions else None)
        wspec = (((4,), I64),) if cfg.wide else ()
        self.junctions = T.make(cl.junction_cap,
                                (((8,), I32), ((8,), I32)) + wspec,
                                device=dev)
        self.sinks = T.make(cl.sink_cap, (((), I32),) + wspec, device=dev)
        self.pairs = T.make(cl.pair_cap, (((), I32),), device=dev)

    # ---- batches ----------------------------------------------------------
    def _rows(self, x):
        """This rank's rows of its host's batch."""
        B, L, i = x.shape[0], self.mesh.per_host, self.mesh.local
        if B % L:
            raise ValueError(f"batch of {B} rows does not split over {L} "
                             "ranks")
        return x[i * B // L:(i + 1) * B // L]

    def _dev(self, a, dtype=None):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device) if dtype is None else a.to(self.device,
                                                             dtype)

    def _lockstep(self, batches):
        """The batch stream, padded with empty batches (of the last
        batch's shape) so that every rank runs as many as the rank with
        the most: hosts feed their own reads, and their batch counts may
        differ. One host: as is."""
        if self.mesh.hosts == 1:
            yield from batches
            return
        it = iter(batches)
        shape = (self.feed_cfg.batch_reads, self.cfg.max_read_length)
        while True:
            nxt = next(it, None)
            if not self.mesh.pmax(nxt is not None):
                return
            if nxt is None:
                nxt = (np.zeros(shape, np.uint8),
                       np.zeros(shape[:1], np.int32))
            shape = tuple(nxt[0].shape)
            yield nxt

    def _prefetch(self, batches):
        from faucet_tpu_torch.io.stream import prefetch_batches

        # the lockstep's collectives stay on this thread, not the reader's
        return self._lockstep(prefetch_batches(batches, self.device))

    def _batches(self, reads, cfg=None):
        from faucet_tpu_torch.pipeline import batch_iter

        return batch_iter(reads, cfg or self.feed_cfg)

    # ---- phase 1 ----------------------------------------------------------
    def load_reads(self, reads):
        self.load_batches(self._batches(reads))

    def load_batches(self, batches):
        m = self.metrics
        m.start("load")
        for bases, lens in self._prefetch(batches):
            self.load_batch(bases, lens)
        self._sync()
        m.stop("load")

    def load_batch(self, bases, lens):
        b = self._rows(self._dev(bases))
        ln = self._rows(self._dev(lens))
        if self.node_cascade is not None:
            self.cascade, self.node_cascade, drops = _load_local_nodes(
                self.mesh, self.cascade, self.node_cascade, b, ln,
                cfg_local=self.cfg_local, **self._kw)
        else:
            self.cascade, drops = _load_local(
                self.mesh, self.cascade, b, ln, cfg_local=self.cfg_local,
                **self._kw)
        self.metrics.add("reads_loaded", int((np.asarray(lens) > 0).sum()))
        self.metrics.add("route_dropped", int(self.mesh.psum(int(drops))))

    # ---- phase 2 ----------------------------------------------------------
    def scan_reads(self, reads):
        # full batch_reads per host, as the reference's scan_reads
        self.scan_batches(self._batches(reads, self.cfg))

    def scan_batches(self, batches):
        m = self.metrics
        m.start("scan")
        for bases, lens in self._prefetch(batches):
            self.scan_batch(bases, lens)
        self._sync()
        m.stop("scan")

    def scan_batch(self, bases, lens):
        """Scan this rank's rows; returns their (jm, canon_hi, canon_lo)."""
        (self.junctions, self.sinks, n_solid, n_junc, jm, chi, clo,
         drops) = _scan_local(
            self.mesh, self.cascade, self.junctions, self.sinks,
            self._rows(self._dev(bases)), self._rows(self._dev(lens)),
            self.node_cascade, cfg=self.cfg, cfg_local=self.cfg_local,
            **self._kw)
        n_solid, n_junc, drops = self.mesh.psum_many(
            [int(n_solid), int(n_junc), int(drops)])
        m = self.metrics
        m.add("reads_scanned", int((np.asarray(lens) > 0).sum()))
        m.add("solid_windows", int(n_solid))
        m.add("junction_hits", int(n_junc))
        m.add("route_dropped", int(drops))
        return jm, chi, clo

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- paired ends ------------------------------------------------------
    def _mate_batches(self, reads):
        """Interleaved mates -> (bases1, lens1, bases2, lens2) batches of
        batch_reads pairs (the last one padded), in lockstep over the
        hosts."""
        from faucet_tpu_torch.io.fastq import deinterleave

        B, L = self.feed_cfg.batch_reads, self.feed_cfg.max_read_length

        def packed():
            m1, m2 = [], []
            for a, b in deinterleave(iter(reads)):
                m1.append(a)
                m2.append(b)
                if len(m1) == B:
                    yield both(m1, m2)
                    m1, m2 = [], []
            if m1:
                pad = [""] * (B - len(m1))
                yield both(m1 + pad, m2 + pad)

        def both(m1, m2):
            (b1, l1), (b2, l2) = KM.pack_reads(m1, L), KM.pack_reads(m2, L)
            return np.concatenate([b1, b2]), np.concatenate([l1, l2])

        for bases, lens in self._lockstep(packed()):
            h = bases.shape[0] // 2
            yield bases[:h], lens[:h], bases[h:], lens[h:]

    def scan_paired(self, reads):
        m = self.metrics
        m.start("scan")
        for packed in self._mate_batches(reads):
            self._scan_pair_packed(*packed)
        self._sync()
        m.stop("scan")

    def _scan_pair_packed(self, b1, l1, b2, l2):
        jm1, chi1, clo1 = self.scan_batch(b1, l1)
        jm2, chi2, clo2 = self.scan_batch(b2, l2)
        self.pairs, unsent = _pairs_local(
            self.mesh, self.pairs, jm1, chi1, clo1, jm2, chi2, clo2,
            **self._kw)
        self.metrics.add("pair_batches", 1)
        self.metrics.add("route_dropped", int(self.mesh.psum(int(unsent))))

    def scan_paired_batches(self, batches):
        """Paired scan over packed interleaved batches: mates are the
        alternating rows of each batch."""
        m = self.metrics
        m.start("scan")
        for bases, lens in self._lockstep(batches):
            self._scan_pair_packed(bases[0::2], lens[0::2], bases[1::2],
                                   lens[1::2])
        self._sync()
        m.stop("scan")

    def _stream_pair_packed(self, b1, l1, b2, l2):
        self.load_batch(b1, l1)
        self.load_batch(b2, l2)
        self._scan_pair_packed(b1, l1, b2, l2)

    def run_streaming(self, reads):
        m = self.metrics
        m.start("stream")
        if self.cfg.paired_ends:
            for packed in self._mate_batches(reads):
                self._stream_pair_packed(*packed)
        else:
            for bases, lens in self._lockstep(self._batches(reads)):
                self.load_batch(bases, lens)
                self.scan_batch(bases, lens)
        self._sync()
        m.stop("stream")
        return self._finish()

    def run_streaming_batches(self, batches):
        """Single pass over packed batches; paired mates ride the
        alternating rows."""
        m = self.metrics
        m.start("stream")
        for bases, lens in self._lockstep(batches):
            if self.cfg.paired_ends:
                self._stream_pair_packed(bases[0::2], lens[0::2],
                                         bases[1::2], lens[1::2])
            else:
                self.load_batch(bases, lens)
                self.scan_batch(bases, lens)
        self._sync()
        m.stop("stream")
        return self._finish()

    def pair_counts(self):
        """Host dict: pair-hash key -> count, over every rank's slice
        (collective)."""
        from faucet_tpu_torch.graph.build import extract_table

        t = extract_table(self.pairs, self.mesh)
        return {(int(h) << 32) | int(l): int(c)
                for h, l, c in zip(t["hi"], t["lo"], t["v0"])}

    def _pair_count_fn(self):
        counts = self.pair_counts()
        if not counts:
            return None
        from faucet_tpu_torch.core.hashing import pair_key_np
        from faucet_tpu_torch.core.kmer import encode_kmer

        def pc(a, b):
            ah, al = encode_kmer(a)
            bh, bl = encode_kmer(b)
            kh, kl = pair_key_np(np.uint32(ah), np.uint32(al),
                                 np.uint32(bh), np.uint32(bl))
            return counts.get((int(kh) << 32) | int(kl), 0)

        return pc

    # ---- global state -----------------------------------------------------
    def global_state(self):
        """(cascade, node_cascade, junctions, sinks, pairs) as the global
        arrays, on every rank (collective): what a checkpoint holds."""
        m = self.mesh
        return (gather_cascade(m, self.cascade),
                (gather_cascade(m, self.node_cascade)
                 if self.node_cascade is not None else None),
                gather_table(m, self.junctions),
                gather_table(m, self.sinks), gather_table(m, self.pairs))

    def place_state(self, cascade, node_cascade, junctions, sinks,
                    pairs=None):
        """Take this rank's slices of global state (a resumed checkpoint)."""
        r, S, dev = self.mesh.rank, self.cfg.n_shards, self.device
        self.cascade = local_cascade(cascade, r, S, dev)
        if node_cascade is not None:
            self.node_cascade = local_cascade(node_cascade, r, S, dev)
        self.junctions = local_table(junctions, r, S, dev)
        self.sinks = local_table(sinks, r, S, dev)
        if pairs is not None:
            self.pairs = local_table(pairs, r, S, dev)

    # ---- host phases ------------------------------------------------------
    def build(self):
        from faucet_tpu_torch.graph.build import GraphBuilder

        cfg, m = self.cfg, self.metrics
        if cfg.prune_slot_cov > 0:
            self.junctions = prune_slots(self.junctions, cfg.prune_slot_cov)
        m.start("build")
        if cfg.route_walks and not cfg.wide:
            gb = GraphBuilder(cfg, self.cascade, self.junctions, self.sinks,
                              mesh=self.mesh)
        else:
            # unrouted walks run on the global arrays (the reference lets
            # XLA partition them); every rank walks alike
            gb = GraphBuilder(cfg, gather_cascade(self.mesh, self.cascade),
                              gather_table(self.mesh, self.junctions),
                              gather_table(self.mesh, self.sinks))
        g = gb.build()
        m.stop("build")
        jc, sc = self.mesh.psum_many([int(self.junctions.count),
                                      int(self.sinks.count)])
        m.add("junctions", int(jc))
        m.add("sink_anchors", int(sc))
        m.add("contigs_raw", len(g.live()))
        m.add("walk_route_bytes", gb.route_bytes)
        return g

    def clean_graph(self, g):
        from faucet_tpu_torch.graph.clean import clean

        cfg = self.cfg
        if cfg.no_cleaning:
            return g
        pc = self._pair_count_fn() if cfg.paired_ends else None
        max_tip = int(cfg.tip_len_factor * cfg.max_read_length)
        if cfg.distributed_clean:
            # halo-exchange partitioned cleaning (dist/halo.py): the same
            # contig set as clean()
            from faucet_tpu_torch.dist.halo import PartitionedCleaner

            cleaner = PartitionedCleaner(g, cfg.n_shards, mesh=self.mesh)
            st = cleaner.clean(max_tip_len=max_tip, min_cov=cfg.min_contig_cov,
                               pair_count=pc)
            for k, v in st.items():
                self.metrics.add(f"clean_{k}", v)
            return cleaner.result()
        st = clean(g, max_tip_len=max_tip, min_cov=cfg.min_contig_cov,
                   pair_count=pc)
        for k, v in st.items():
            self.metrics.add(f"clean_{k}", v)
        return g

    def _finish(self):
        g = self.clean_graph(self.build())
        self.metrics.add("contigs", len(g.live()))
        if self.mesh.rank == 0:
            self.metrics.emit("assembly_done", stats=g.stats())
        return g

    def run_file_mode(self, load_reads, scan_reads):
        self.load_reads(load_reads)
        self.scan_reads(scan_reads)
        return self._finish()


def prune_slots(junctions: T.Table, min_slot_cov: int) -> T.Table:
    """Device pre-clean: zero the junction slots (cov8 entries) whose
    coverage is below the floor before walking; the other value columns
    are left as they are. Elementwise, so a sharded table prunes each
    shard locally. Every pruned slot is a contig the host's low-coverage
    pass would have removed, but it is never walked."""
    cov8 = junctions.vals[0]
    keep = cov8 >= min_slot_cov
    return junctions._replace(
        vals=(torch.where(keep, cov8, 0),) + tuple(junctions.vals[1:]))
