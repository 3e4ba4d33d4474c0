"""Phase-3 graph build: device walks -> host ContigGraph.

Port of faucet_tpu/graph/build.py. Given a mesh (dist/), the state is one
rank's hash-range slice: the extracts gather every rank's occupied rows
and the walks route their probes (dist/swalk.py). A codec hides the
difference between narrow codes (k <= 31: the table keys ARE the canonical
codes) and wide ones (k > 31: fingerprint keys, the four code words stored
as a table value, core/wide.py). All walks run as one lockstep device
frontier (graph/walk.py); the host decodes the base strips and assembles
Contig records. Pass 2 rebuilds junction-free components from sink
anchors in chunks, filtering later sinks through the k-mers already
visited. The host logic is the reference's line for line, except that
pass 1's contigs are keyed and marked visited in one call (the same
visited set); the device side differs in three ways:
extract_table gathers only occupied rows on the device before the copy
to the host, frontier compaction stays on the device, and the walk's
junction test is a sorted-key search over the extracted junction keys
(walk.sorted_member: the same answers as table.lookup, without its
host-synced probe rounds per step).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core import wide as WD
from faucet_tpu_torch.core.kmer import (decode_kmer, decode_kmers_np,
                                        encode_kmer, encode_windows_np,
                                        neighbor_keys_np, revcomp_code_np,
                                        revcomp_seq)
from faucet_tpu_torch.graph import walk as W
from faucet_tpu_torch.graph.model import Contig, ContigGraph, End

_CODEBOOK = "ACGT"


def extract_table(tbl: T.Table, mesh=None):
    """Occupied rows of a device table -> host numpy dict (hi, lo uint32;
    v<i> in the table's dtypes). Only the occupied rows leave the device.

    mesh: `tbl` is one rank's slice of a hash-range-sharded table; every
    rank gathers the occupied rows of all slices, in rank order (callers
    sort by key; collective). Each rank owns a distinct hash range, so a
    row is never gathered twice."""
    idx = torch.nonzero(T.occupied_mask(tbl)).squeeze(1)
    rows = lambda a: a[idx] if mesh is None else mesh.fetch_rows(a[idx])
    out = {"hi": u2.to_np_u32(rows(tbl.keys_hi)),
           "lo": u2.to_np_u32(rows(tbl.keys_lo))}
    for i, v in enumerate(tbl.vals):
        out[f"v{i}"] = rows(v).cpu().numpy()
    return out


def _pad_pow2(n: int, lo: int = 256) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class _NarrowCodec:
    """k <= 31: table keys are the canonical 2-word codes."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.k = cfg.size_kmer
        self.device = device

    def seed_payload(self, t, rows):
        return {"hi": t["hi"][rows], "lo": t["lo"][rows]}

    def node_strs(self, t, rows):
        keys = u2.to_int(t["hi"], t["lo"])[np.asarray(rows, np.int64)]
        return decode_kmers_np(keys, self.k)

    def key_windows(self, s: str) -> np.ndarray:
        """uint64 table keys of every canonical k-window of a string."""
        return encode_windows_np(s, self.k)

    def key_windows_many(self, seqs) -> np.ndarray:
        """key_windows of every string, concatenated."""
        return np.concatenate([np.zeros(0, np.uint64)]
                              + [encode_windows_np(s, self.k) for s in seqs])

    def make_frontier(self, payload, dirs, forced, active, circle_ok,
                      pad):
        chi = pad(payload["hi"], 0)
        clo = pad(payload["lo"], 0)
        rc = revcomp_code_np(u2.to_int(chi, clo), self.k)
        dev = lambda a: torch.from_numpy(
            np.ascontiguousarray(a)).to(self.device)
        return W.make_frontier(
            dev(chi.astype(np.int64)), dev(clo.astype(np.int64)),
            dev((rc >> np.uint64(32)).astype(np.int64)),
            dev((rc & np.uint64(0xFFFFFFFF)).astype(np.int64)),
            dev(pad(np.asarray(dirs, np.int64), 0)),
            dev(pad(np.asarray(forced, np.int64), -1)),
            dev(active), dev(pad(np.asarray(circle_ok, bool), False)))

    def end_state(self, fr):
        """Host snapshot of every lane's canonical endpoint key."""
        f = u2.pack(fr.fhi, fr.flo)
        r = u2.pack(fr.rhi, fr.rlo)
        c = torch.minimum(f, r)
        return {"hi": u2.to_np_u32(c >> 32), "lo": u2.to_np_u32(c & u2.M32)}

    def end_keys(self, st, idx):
        return u2.to_int(st["hi"][idx], st["lo"][idx])

    def end_str(self, st, i) -> str:
        return decode_kmer(int(st["hi"][i]), int(st["lo"][i]), self.k)

    def key_of_str(self, s: str) -> int:
        """Canonical table key of a k-mer string (host)."""
        hi, lo = encode_kmer(min(s, revcomp_seq(s)))
        return (hi << 32) | lo

    def walk_round(self):
        return W.walk_round  # looked up per call (the smoke times it)

    def resolver(self):
        return W.resolve_ambiguous


class _WideCodec:
    """k > 31: fingerprint keys; the true four-word codes stored as the
    table value `words_col` (uint32 values as int64)."""

    def __init__(self, cfg, device, words_col: str):
        self.cfg = cfg
        self.k = cfg.size_kmer
        self.device = device
        self.words_col = words_col

    def seed_payload(self, t, rows):
        return {"words": t[self.words_col][rows]}

    def node_strs(self, t, rows):
        return [WD.decode_kmer_wide(t[self.words_col][i], self.k)
                for i in rows]

    def key_windows(self, s: str) -> np.ndarray:
        return WD.encode_windows_wide_np(s, self.k)

    def key_windows_many(self, seqs) -> np.ndarray:
        return WD.encode_windows_wide_many_np(seqs, self.k)

    def make_frontier(self, payload, dirs, forced, active, circle_ok,
                      pad):
        words = np.asarray(payload["words"], np.uint32)   # [n, 4]
        rcw = WD.revcomp_words_np(words, self.k)
        dev = lambda a: torch.from_numpy(
            np.ascontiguousarray(a)).to(self.device)
        wdev = lambda a: dev(pad(a.astype(np.int64), 0).T)  # [4, Wp]
        return W.make_frontier_wide(
            wdev(words), wdev(rcw), dev(pad(np.asarray(dirs, np.int64), 0)),
            dev(pad(np.asarray(forced, np.int64), -1)), dev(active),
            dev(pad(np.asarray(circle_ok, bool), False)))

    def end_state(self, fr):
        canon, _ = WD.canon_of_wide(fr.fwd, fr.rc)
        khi, klo = WD.fingerprint(canon)
        return {"hi": u2.to_np_u32(khi), "lo": u2.to_np_u32(klo),
                "words": u2.to_np_u32(canon.T)}

    def end_keys(self, st, idx):
        return u2.to_int(st["hi"][idx], st["lo"][idx])

    def end_str(self, st, i) -> str:
        return WD.decode_kmer_wide(st["words"][i], self.k)

    def walk_round(self):
        return W.walk_round_wide  # looked up per call (the smoke times it)

    def resolver(self):
        return W.resolve_ambiguous_wide


class GraphBuilder:
    """mesh: the state is one rank's hash-range slice (dist/sharded.py)
    and the walks route their probes to the owning ranks (dist/swalk.py;
    narrow codes with cfg.route_walks only, as the reference's). Every
    rank of the mesh builds, and gets the same graph. route_bytes: the
    routed walks' bytes."""

    def __init__(self, cfg, cascade: BL.Cascade, junctions: T.Table,
                 sinks: T.Table, mesh=None):
        if mesh is not None and (cfg.wide or not cfg.route_walks):
            raise ValueError("routed walks need narrow codes and "
                             "route_walks; walk unrouted on the gathered "
                             "global arrays (dist/sharded.py)")
        self.cfg = cfg
        self.cascade = cascade
        self.junctions = junctions
        self.sinks = sinks
        self.mesh = mesh
        self.route_bytes = 0
        self.device = cascade.b_bloom.words.device
        if cfg.wide:
            # junction codes in value 2 (after cov8, dist8), sink codes in 1
            self.codec_j = _WideCodec(cfg, self.device, "v2")
            self.codec_s = _WideCodec(cfg, self.device, "v1")
        else:
            self.codec_j = self.codec_s = _NarrowCodec(cfg, self.device)
        self._junc_fn = None  # the walks' junction oracle, set by build()

    # ---- device walk driver --------------------------------------------
    @staticmethod
    def _gather_frontier(fr, idx: np.ndarray, newp: int):
        """Compact a frontier to the idx lanes, zero-padded to newp
        (the pow2 ladder of the reference; done on the device). Lanes are
        the last dimension of every field ([4, W] wide words included)."""
        it = torch.from_numpy(idx.astype(np.int64)).to(fr.steps.device)

        def g(leaf):
            out = torch.zeros(leaf.shape[:-1] + (newp,), dtype=leaf.dtype,
                              device=leaf.device)
            out[..., :len(idx)] = leaf[..., it]
            return out

        return type(fr)(*(g(leaf) for leaf in fr))

    def _run_walks(self, codec, payload, dirs, forced, circle_ok):
        """Run all walks to completion in lockstep waves, COMPACTING the
        frontier whenever <=1/4 of lanes are still active."""
        cfg = self.cfg
        n = len(dirs)
        assert n > 0
        Wp = _pad_pow2(n)

        def pad(a, fill):
            a = np.asarray(a)
            out = np.full((Wp,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return out

        active = np.zeros(Wp, bool)
        active[:n] = True
        fr = codec.make_frontier(payload, dirs, forced, active,
                                 circle_ok, pad)
        orig = np.arange(Wp)  # current lane -> original lane
        parts: List[List[np.ndarray]] = [[] for _ in range(n)]
        res_kind = np.zeros(n, np.int32)
        res_slot = np.full(n, -1, np.int32)
        res_steps = np.zeros(n, np.int32)
        res_key = np.zeros(n, np.uint64)
        res_str: List[Optional[str]] = [None] * n

        def capture(fr, lane_mask: np.ndarray):
            idx = np.nonzero(lane_mask[: len(orig)])[0]
            o = orig[idx]
            keep = o < n
            idx, o = idx[keep], o[keep]
            if not len(idx):
                return
            st = codec.end_state(fr)
            res_kind[o] = fr.end_kind.cpu().numpy()[idx]
            res_slot[o] = fr.entry_slot.cpu().numpy()[idx]
            res_steps[o] = fr.steps.cpu().numpy()[idx]
            res_key[o] = codec.end_keys(st, idx)
            for j, oi in zip(idx, o):
                if res_kind[oi] == W.END_JUNCTION:
                    res_str[oi] = codec.end_str(st, j)

        total = 0
        R = max(1, cfg.walk_rounds_per_call)
        # warmup ramp: two short calls let the compaction shrink the grid
        # to the genuine long walks before the big calls run
        warmup = [(1, min(64, cfg.walk_round_steps)),
                  (1, cfg.walk_round_steps)]
        while total < cfg.max_contig_len:
            rr, ss = warmup.pop(0) if warmup else (R,
                                                   cfg.walk_round_steps)
            if self.mesh is not None:
                fr, bases = self._routed_waves(fr, rr, ss)
            else:
                fr, bases, _r = W.walk_waves(
                    self.cascade, self.junctions, fr, n_rounds=rr,
                    n_steps=ss, cfg=cfg,
                    walk_fn=functools.partial(codec.walk_round(),
                                              junc_fn=self._junc_fn),
                    resolve_fn=codec.resolver())
            b = bases.cpu().numpy()
            mask = b != 255
            counts = mask.sum(axis=1)
            segs = np.split(b[mask], np.cumsum(counts)[:-1])
            for i in np.nonzero(counts[: len(orig)])[0]:
                if orig[i] < n:
                    parts[orig[i]].append(segs[i])
            total += rr * ss
            # pending = active or not-yet-judged ambiguous retirees
            act = (fr.active | (fr.end_kind == W.END_AMBIG)).cpu().numpy()
            live = int(act.sum())
            if live == 0:
                break
            cur = act.shape[0]
            if live <= cur // 4 and cur > 64:
                newp = _pad_pow2(live, lo=64)
                capture(fr, ~act)
                idx = np.nonzero(act)[0]
                fr = self._gather_frontier(fr, idx, newp)
                orig = orig[idx]
        capture(fr, np.ones(fr.active.shape[0], bool))
        empty = np.empty(0, np.uint8)
        return {
            "bases": [np.concatenate(p) if p else empty for p in parts],
            "end_kind": res_kind,
            "entry_slot": res_slot,
            "steps": res_steps,
            "end_key": res_key,
            "end_str": res_str,
        }

    def _routed_waves(self, fr, n_rounds: int, n_steps: int):
        """One wave call with the frontier's lanes split over the ranks:
        this rank walks its share with routed probes, then every rank
        gathers the whole frontier and strip back (the host driver runs
        on every rank alike)."""
        from faucet_tpu_torch.dist.swalk import walk_waves_routed

        mesh = self.mesh
        Wl = fr.steps.shape[0] // mesh.n_shards
        lanes = slice(mesh.rank * Wl, (mesh.rank + 1) * Wl)
        fr_l, bases, rb = walk_waves_routed(
            mesh, self.cascade, self._owned_keys,
            type(fr)(*(f[lanes] for f in fr)), n_rounds, n_steps, self.cfg)
        self.route_bytes += rb
        packed = mesh.fetch(torch.stack([f.to(torch.int64) for f in fr_l],
                                        dim=1))
        fr = type(fr)(*(packed[:, i].to(f.dtype)
                        for i, f in enumerate(fr_l)))
        return fr, mesh.fetch(bases)

    # ---- contig assembly -------------------------------------------------
    def _strip_to_str(self, row: np.ndarray, steps: int) -> str:
        return "".join(_CODEBOOK[b] for b in row[:steps])

    def build(self) -> ContigGraph:
        cfg = self.cfg
        k = cfg.size_kmer
        jt = extract_table(self.junctions, self.mesh)
        n_j = len(jt["hi"])
        cov8 = jt.get("v0", np.zeros((0, 8), np.int32))
        dist8 = jt.get("v1", np.zeros((0, 8), np.int32))
        jkeys = u2.to_int(jt["hi"], jt["lo"])
        order = np.argsort(jkeys, kind="stable")
        for key in list(jt.keys()):
            jt[key] = jt[key][order]
        jkeys, cov8, dist8 = jkeys[order], cov8[order], dist8[order]
        jcov_by_key: Dict[int, np.ndarray] = {
            int(kk): cov8[i] for i, kk in enumerate(jkeys)}
        all_rows = list(range(n_j))
        jnode_strs = self.codec_j.node_strs(jt, all_rows) if n_j else []
        # the walks' junction oracle: the sorted occupied keys (routed
        # walks: this rank's own, which answer the junction tests routed
        # to it; dist/swalk.py)
        if self.mesh is None:
            self._junc_fn = W.sorted_member(torch.from_numpy(
                jkeys.astype(np.int64)).to(self.device))
        else:
            occ = T.occupied_mask(self.junctions)
            self._owned_keys = torch.sort(u2.pack(
                u2.from_i32(self.junctions.keys_hi[:-1][occ]),
                u2.from_i32(self.junctions.keys_lo[:-1][occ]))).values

        # sink/cap anchors (extracted once; pass-1 FP-trim + pass-2 seeds)
        st = extract_table(self.sinks, self.mesh)
        skeys = u2.to_int(st["hi"], st["lo"])
        order = np.argsort(skeys, kind="stable")
        for key in list(st.keys()):
            st[key] = st[key][order]
        self._sink_keys = np.sort(np.asarray(skeys, np.uint64))

        by_key: Dict[str, Contig] = {}

        # ---- pass 1: walks from every covered junction slot -------------
        rows, slots = np.nonzero(cov8 > 0)
        if len(rows):
            dirs = (slots >= 4).astype(np.int32)
            forced = np.where(slots < 4, slots, 3 - (slots - 4)).astype(
                np.int32)
            out = self._run_walks(self.codec_j,
                                  self.codec_j.seed_payload(jt, rows),
                                  dirs, forced, np.zeros(len(rows), bool))
            for i in range(len(rows)):
                c = self._pass1_contig(
                    jnode_strs[rows[i]], int(slots[i]), cov8[rows[i]],
                    dist8[rows[i]], out, i, jcov_by_key)
                if c is not None:
                    by_key.setdefault(c.canonical_seq(), c)

        # visited k-mers as uint64 table keys in sorted chunks, merged
        # LSM-style (adjacent chunks within 2x size merge on append)
        chunks: List[np.ndarray] = []

        def mark_visited(c: Contig):
            src = c.seq + (c.seq[: k - 1] if c.circular else "")
            w = self.codec_s.key_windows(src)
            if not len(w):
                return
            w.sort()
            chunks.append(w)
            while len(chunks) >= 2 and \
                    len(chunks[-2]) <= 2 * len(chunks[-1]):
                b = chunks.pop()
                a = chunks.pop()
                m = np.concatenate([a, b])
                m.sort()
                chunks.append(m)

        def visited_mask(keys: np.ndarray) -> np.ndarray:
            hit = np.zeros(len(keys), bool)
            for ch in chunks:
                idx = np.searchsorted(ch, keys)
                idx = np.minimum(idx, len(ch) - 1)
                hit |= ch[idx] == keys
            return hit

        # pass 1's contigs go in as one sorted chunk, keyed in one call
        # (membership is the same as marking them one by one)
        w = self.codec_s.key_windows_many(
            [c.seq + (c.seq[: k - 1] if c.circular else "")
             for c in by_key.values()])
        if len(w):
            w.sort()
            chunks.append(w)

        # ---- pass 2: junction-free components from sink anchors ---------
        jset = np.asarray(sorted({int(x) for x in jkeys}), np.uint64)
        n_s = len(st["hi"])
        skeys_s = u2.to_int(st["hi"], st["lo"])
        chunk = 4096
        pend = np.arange(n_s)[~np.isin(skeys_s, jset)]
        while len(pend):
            live = ~visited_mask(skeys_s[pend])
            pend = pend[live]
            if len(pend) and not cfg.wide:
                # seeds one base OFF walked territory walk straight back
                # onto it; skip them by testing the 8 neighbors
                nbr = neighbor_keys_np(skeys_s[pend], k)
                hit = visited_mask(nbr.ravel()).reshape(nbr.shape)
                pend = pend[~hit.any(axis=1)]
            batch = pend[:chunk].tolist()
            pend = pend[chunk:]
            if not batch:
                break
            snode_strs = {i: s for i, s in zip(
                batch, self.codec_s.node_strs(st, batch))}
            new = self._pass2_contigs(st, batch, snode_strs)
            for c in new:
                key = c.canonical_seq()
                if key in by_key:
                    continue
                # drop near-duplicates of already-walked paths (a sink
                # anchor one base OFF a real path re-walks it)
                w = self.codec_s.key_windows(
                    c.seq + (c.seq[: k - 1] if c.circular else ""))
                if len(w) and visited_mask(w).mean() > 0.5:
                    continue
                by_key[key] = c
                mark_visited(c)

        g = ContigGraph(k, list(by_key.values()))
        # repair merged walks (missed-junction port clashes) before
        # cleaning — see clean.resolve_port_clashes
        from faucet_tpu_torch.graph.clean import (repair_ports,
                                                  resolve_port_clashes)

        resolve_port_clashes(g)
        repair_ports(g)
        return g

    def _pass1_contig(self, node: str, slot: int, cov8, dist8, out, i,
                      jcov_by_key) -> Optional[Contig]:
        cfg = self.cfg
        k = cfg.size_kmer
        w0 = node if slot < 4 else revcomp_seq(node)
        steps = int(out["steps"][i])
        kind = int(out["end_kind"][i])
        bases = self._strip_to_str(out["bases"][i], steps)
        seq = w0 + bases
        dist = int(dist8[slot])
        if kind in (W.END_DEAD, W.END_AMBIG, W.RUNNING):
            if steps > dist:
                # trim the Bloom-FP tail back to real coverage: deepest
                # walked window that is a sink/cap anchor, with the
                # junction's dist bound as the floor
                wk = self.codec_s.key_windows(seq[dist:])
                hits = np.nonzero(self._is_sink(wk))[0]
                keep = dist + (int(hits.max()) if len(hits) else 0)
                if keep:
                    seq = seq[: k + keep]
            cov = float(cov8[slot])
            return Contig(seq=seq, cov=cov, left=End(node, slot),
                          right=None)
        if kind == W.END_JUNCTION:
            end_key = int(out["end_key"][i])
            end_node = out["end_str"][i]
            eslot = int(out["entry_slot"][i])
            ecov = jcov_by_key.get(end_key)
            cov = (float(cov8[slot]) + (float(ecov[eslot])
                                        if ecov is not None else 0.0)) / 2
            return Contig(seq=seq, cov=cov, left=End(node, slot),
                          right=End(end_node, eslot))
        # circular cannot happen for junction-seeded walks (circle_ok off)
        return None

    def _trim_open_ends(self, seq: str, left_open: bool,
                        right_open: bool) -> str:
        """Trim Bloom-FP tail bases off walk ends that did not land on a
        junction: cut back to the outermost windows that are sink/cap
        anchors."""
        if not (left_open or right_open):
            return seq
        k = self.cfg.size_kmer
        if len(seq) < k:
            return seq
        wk = self.codec_s.key_windows(seq)
        pos = np.nonzero(self._is_sink(wk))[0]
        if not len(pos):
            return seq
        lo = int(pos.min()) if left_open else 0
        hi = int(pos.max()) if right_open else len(wk) - 1
        return seq[lo:hi + k]

    def _is_sink(self, keys: np.ndarray) -> np.ndarray:
        """Membership of keys in the (pre-sorted) sink anchor set."""
        sk = self._sink_keys
        if not len(sk):
            return np.zeros(len(keys), bool)
        idx = np.minimum(np.searchsorted(sk, keys), len(sk) - 1)
        return sk[idx] == keys

    def _pass2_contigs(self, st, batch, snode_strs) -> List[Contig]:
        n = len(batch)
        zeros = np.zeros(n, np.int32)
        payload = self.codec_s.seed_payload(st, batch)
        rout = self._run_walks(self.codec_s, payload, zeros, zeros - 1,
                               np.ones(n, bool))
        lout = self._run_walks(self.codec_s, payload, zeros + 1,
                               zeros - 1, np.ones(n, bool))
        scov = st["v0"]
        contigs = []
        for j, i in enumerate(batch):
            start = snode_strs[i]
            cov = float(scov[i])
            rsteps = int(rout["steps"][j])
            rb = self._strip_to_str(rout["bases"][j], rsteps)
            if int(rout["end_kind"][j]) == W.END_CIRCULAR:
                contigs.append(Contig(seq=(start + rb)[:rsteps], cov=cov,
                                      circular=True))
                continue
            lsteps = int(lout["steps"][j])
            lb = self._strip_to_str(lout["bases"][j], lsteps)
            seq = revcomp_seq(revcomp_seq(start) + lb) + rb
            left = None
            if int(lout["end_kind"][j]) == W.END_JUNCTION:
                left = End(lout["end_str"][j], int(lout["entry_slot"][j]))
            right = None
            if int(rout["end_kind"][j]) == W.END_JUNCTION:
                right = End(rout["end_str"][j], int(rout["entry_slot"][j]))
            seq = self._trim_open_ends(seq, left is None, right is None)
            contigs.append(Contig(seq=seq, cov=cov, left=left,
                                  right=right))
        return contigs
