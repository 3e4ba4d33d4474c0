# Host code copied from faucet_tpu/dist/halo.py; the imports point at
# faucet_tpu_torch, and Exchange._device_a2a transposes the message buffer
# on the mesh's torch device instead of a jax shard_map all_to_all.
"""Halo-exchange distributed graph cleaning (SURVEY.md §5 "long-context
analog", §7.1.4; PARITY.md §config5 item 3; reference analogue: the
cleaning fixpoint of ref:src/ContigGraph.cpp run on a graph too large
for one host).

Contigs are partitioned across shards by the hash of an end node; each
round every shard runs the SAME delete/collapse rules as the host
`graph/clean.py` passes on its owned contigs only, and cross-shard
effects ride fixed-width numeric control messages exchanged through ONE
`lax.all_to_all` per sub-step (the mesh collective plane — the same
fixed-capacity + overflow-carry discipline as dist/route.py; every
collective moves the same n*n*cap*W buffer regardless of skew, and the
trip count is ceil(hottest-pair rows / cap)). Rules that need a node's
global view (per-anchor tip arbitration, effective attachment = "does
this node keep other ports", 1-in/1-out collapse detection) are
arbitrated by the NODE's owner shard, which holds the authoritative
port registry for its hash range — degrees therefore never need
broadcasting; only O(cut) boundary rows move. Contig sequence payloads
for cross-shard merges move on the host object plane (stand-in for the
DCN transfer; bytes counted).

Round-4 parity rework: classification mirrors graph/clean._classify
exactly — effective attachment (END_INFO/END_STATUS handshake with the
node owner), the TIP_KEEP_RATIO long-tip rule, ISO_COV_MULT isolated
threshold, keep-strongest (cov, seq_rank64, slot) anchor arbitration —
and the bubble round carries arm length + rank so the arbiter applies
pop_bubbles' FULL kill predicate (ratio rule, EQLEN_RATIO equal-length
rule, (cov, rank) top-arm pick) and survivor ports re-register with
setdefault semantics (VERDICT r3 #4, ADVICE r3 items 1-2).

Global fixpoint: per-round change counters are max-reduced across shards
(the pmax of the design note); rounds repeat until no shard changed.

Equivalence to the sequential clean(): contig SEQUENCES and topology are
identical (tests/dist/test_halo.py); contig cov can differ by <1% because
merge_through's pairwise weighted mean re-counts the shared node window
per merge, so it is not associative across merge orders — a property of
the sequential code, not of the partitioning.

Message tags (all rows are uint32[W=12], zero-padded):
  1  TIP_CAND   -> node owner   (anchor arbitration, keep-strongest)
  2  KILL       -> contig owner (verdicts; apply all kills together)
  3  PORT_DEL   -> node owner   (guarded registry deletes)
  4+5 MERGE     -> contig owner (collapse proposals, paired rows)
  6  PORT_MOVE  -> node owner   (merged contig re-registers far ends)
  7  BUBBLE_ARM -> pair arbiter (cov+len+rank; full pop_bubbles rule)
  8  END_INFO   -> node owner   (per-claim contig cov: the claim map)
  9  END_STATUS -> contig owner (n_other + max-other-cov per end)
 10  SURVIVOR   -> contig owner (popped-group survivor notice)
 11  PORT_SET   -> node owner   (setdefault re-registration)
 12  REPAIR     -> node owner   (strongest-claimant fill of empty slots)
 13  FAR_INFO   -> node owner   (far-end node code behind each port)
 14  DMERGE     -> contig owner (disentangle transaction votes)
 15  CHAIN_HALF -> R owner      (3-port node's flank ports + far codes)
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from faucet_tpu_torch.core.hashing import hash_pair_np
from faucet_tpu_torch.core.kmer import encode_windows_np, revcomp_seq
from faucet_tpu_torch.graph.clean import (EQLEN_RATIO, ISO_COV_MULT,
                                          TIP_KEEP_RATIO, arm_key,
                                          seq_rank64)
from faucet_tpu_torch.graph.model import Contig, ContigGraph, End

_GID_SHIFT = 40  # gid = (owner_shard << 40) | local_serial


def _node_code(node: str, k: int) -> int:
    return int(encode_windows_np(node, k)[0])


def _owner_of_code(code: int, n_shards: int) -> int:
    h, _ = hash_pair_np(np.uint32(code >> 32),
                        np.uint32(code & 0xFFFFFFFF))
    return int(h) >> (32 - (n_shards - 1).bit_length()) if n_shards > 1 \
        else 0


def _f64(v: float) -> Tuple[int, int]:
    a, b = struct.unpack("<II", struct.pack("<d", v))
    return a, b


def _unf64(a: int, b: int) -> float:
    return struct.unpack("<d", struct.pack("<II", a, b))[0]


class Exchange:
    """Fixed-capacity numeric message exchange over the mesh all_to_all.

    One `exchange()` call drains its outbox through one or more
    collectives: each trip moves a fixed [n, n, CAP, W] uint32 buffer
    (independent of the hottest shard — dist/route.py's discipline),
    rows beyond CAP per (src, dst) pair carry over to the next trip, and
    the trip count is ceil(max pending rows per pair / CAP). Without a
    mesh (pure-host unit tests) the transpose happens in numpy with
    identical semantics and accounting."""

    W = 12
    CAP = 256

    def __init__(self, n_shards: int, mesh=None, cap: int = 0):
        self.n = n_shards
        self.mesh = mesh
        self.cap = cap or self.CAP
        self.bytes = 0
        self.rounds = 0

    def _device_a2a(self, buf: np.ndarray) -> np.ndarray:
        # the reference's one-process shard_map all_to_all over n devices
        # moves chunk [src, dst] to device dst: the [n, n, cap, W] buffer
        # transposed, here on the mesh's device
        import torch

        t = torch.from_numpy(buf.view(np.int32)).to(self.mesh.device)
        return t.transpose(0, 1).contiguous().cpu().numpy().view(np.uint32)

    def exchange(self, outbox: List[List[List[Tuple[int, ...]]]]
                 ) -> List[List[List[Tuple[int, ...]]]]:
        """outbox[src][dst] = list of tuples (<= W uint32 fields).
        Returns inbox[dst][src] with the same rows (order preserved)."""
        n, W, cap = self.n, self.W, self.cap
        inbox = [[[] for _ in range(n)] for _ in range(n)]
        off = 0
        pending = max(len(outbox[s][d]) for s in range(n)
                      for d in range(n))
        while True:
            buf = np.zeros((n, n, cap, W), np.uint32)
            cnt = np.zeros((n, n), np.int32)
            for s in range(n):
                for d in range(n):
                    rows = outbox[s][d][off:off + cap]
                    cnt[s, d] = len(rows)
                    for i, r in enumerate(rows):
                        for j, v in enumerate(r):
                            buf[s, d, i, j] = np.uint32(v & 0xFFFFFFFF)
            self.rounds += 1
            self.bytes += int(buf.nbytes + cnt.nbytes)
            if self.mesh is not None:
                recv = self._device_a2a(buf)     # [dst][src][cap][W]
            else:
                recv = buf.transpose(1, 0, 2, 3)
            rcnt = cnt.T
            for d in range(n):
                for s in range(n):
                    inbox[d][s].extend(
                        tuple(int(x) for x in recv[d, s, i])
                        for i in range(rcnt[d, s]))
            off += cap
            if off >= pending:
                break
        return inbox


def _u64(hi32_lo32: Tuple[int, int]) -> int:
    return (hi32_lo32[0] << 32) | hi32_lo32[1]


def _split64(v: int) -> Tuple[int, int]:
    return (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF


@dataclasses.dataclass
class _Shard:
    contigs: Dict[int, Contig]
    # authoritative registry for nodes this shard OWNS:
    #   node code -> slot -> (gid, 'L'|'R')
    ports: Dict[int, Dict[int, Tuple[int, str]]]
    serial: int = 0


class PartitionedCleaner:
    """8-shard (or any pow2) partitioned clean() with halo exchange.

    Produces the same cleaned contig set as graph/clean.clean() with
    pair_count=None (tips + low-cov + isolated + bubbles + collapse to
    fixpoint); differential-tested in tests/dist/test_halo.py."""

    def __init__(self, g: ContigGraph, n_shards: int, mesh=None):
        self.k = g.k
        self.n = n_shards
        self.ex = Exchange(n_shards, mesh)
        self.payload_bytes = 0
        self.bubbles = 0
        self.chimeric = 0
        self.repaired = 0
        # per-node claim counts gathered by each round's END_INFO pass
        # (node owner view), consumed by the tip-anchor arbitration
        self._claim_n: List[Dict[int, int]] = [
            {} for _ in range(n_shards)]
        self.shards = [_Shard({}, {}) for _ in range(n_shards)]
        gid_of = {}
        for i in g.live():
            c = g.contigs[i]
            gid_of[i] = self._add_contig(self._contig_owner(c), c,
                                         register=False)
        # replicate the HANDED registry exactly (build's registry is not
        # pure last-writer-wins after repair_ports/port-clash surgery):
        # each registered (node, slot) -> same contig on its owner shard
        for node, d in g.ports.items():
            code = _node_code(node, self.k)
            own = _owner_of_code(code, self.n)
            for slot, (ci, end) in d.items():
                if ci in gid_of:
                    self.shards[own].ports.setdefault(code, {})[slot] = (
                        gid_of[ci], end)

    # ---- ownership -------------------------------------------------------
    def _contig_owner(self, c: Contig) -> int:
        e = c.left or c.right
        if e is not None:
            return _owner_of_code(_node_code(e.node, self.k), self.n)
        return _owner_of_code(_node_code(
            min(c.seq[: self.k], revcomp_seq(c.seq)[: self.k]), self.k),
            self.n)

    def _new_gid(self, shard: int) -> int:
        s = self.shards[shard]
        gid = (shard << _GID_SHIFT) | s.serial
        s.serial += 1
        return gid

    def _add_contig(self, shard: int, c: Contig, register: bool = True
                    ) -> int:
        gid = self._new_gid(shard)
        self.shards[shard].contigs[gid] = c
        # register ports at each end node's OWNER shard (direct insert:
        # partition setup is a bulk load, not a per-round halo message).
        # register=False when the caller replicates a handed registry
        # verbatim instead (see __init__)
        if register:
            for e, end in ((c.left, "L"), (c.right, "R")):
                if e is None:
                    continue
                code = _node_code(e.node, self.k)
                own = _owner_of_code(code, self.n)
                self.shards[own].ports.setdefault(code, {})[e.slot] = (
                    gid, end)
        return gid

    def _drop_ports_msgs(self, gid: int, c: Contig, out):
        src = gid >> _GID_SHIFT
        for e in (c.left, c.right):
            if e is None:
                continue
            code = _node_code(e.node, self.k)
            own = _owner_of_code(code, self.n)
            hi, lo = _split64(code)
            out[src][own].append((3, hi, lo, e.slot, gid >> 32,
                                  gid & 0xFFFFFFFF))

    def _apply_port_dels(self, inbox):
        for d in range(self.n):
            for src in range(self.n):
                for m in inbox[d][src]:
                    _, hi, lo, slot, g1, g2 = m[:6]
                    code = _u64((hi, lo))
                    dslot = self.shards[d].ports.get(code)
                    if dslot and dslot.get(slot, (None,))[0] == \
                            _u64((g1, g2)):
                        del dslot[slot]
                        if not dslot:
                            del self.shards[d].ports[code]

    # ---- the round -------------------------------------------------------
    def _empty_out(self):
        return [[[] for _ in range(self.n)] for _ in range(self.n)]

    def _end_statuses(self) -> Dict[int, Dict[str, Tuple[int, float]]]:
        """The effective-attachment handshake (mirrors clean._eff_ends
        on partitioned state).

        Every live contig sends END_INFO (tag 8) for each attached end
        to the end node's owner; the arriving rows ARE the node's claim
        map (clean._claims — every live end referencing the node,
        registry-independent), so the owner replies END_STATUS (tag 9)
        with n_other (CLAIMS at the node from a DIFFERENT contig) and
        max_other_cov over those claims, exactly the sequential
        classifier's ground-truth view (the registry is lossy under
        (node, slot) clashes). The per-node claim counts are also
        retained for this round's tip-anchor arbitration. Returns, per
        contig owner view: {gid: {"L"|"R": (n_other, max_other_cov)}};
        missing entry = end is None (unattached)."""
        n, k = self.n, self.k
        out = self._empty_out()
        for s in range(n):
            for gid, c in self.shards[s].contigs.items():
                if c.circular:
                    continue
                for e, is_l in ((c.left, 1), (c.right, 0)):
                    if e is None:
                        continue
                    code = _node_code(e.node, k)
                    own = _owner_of_code(code, n)
                    hi, lo = _split64(code)
                    cv = _f64(c.cov)
                    out[s][own].append((8, hi, lo, e.slot, gid >> 32,
                                        gid & 0xFFFFFFFF, cv[0], cv[1],
                                        is_l))
        inbox = self.ex.exchange(out)
        out = self._empty_out()
        for d in range(n):
            # per node: the querying ends and each registry port's cov
            by_node: Dict[int, List[Tuple[int, int, int, float]]] = {}
            for src in range(n):
                for m in inbox[d][src]:
                    _, hi, lo, slot, g1, g2, c0, c1, is_l = m[:9]
                    by_node.setdefault(_u64((hi, lo)), []).append(
                        (slot, _u64((g1, g2)), is_l, _unf64(c0, c1)))
            claim_n = {}
            for code, rows in by_node.items():
                # the rows ARE the claim map (clean._claims): attachment
                # and max-other-cov count every live end referencing the
                # node, NOT the lossy (node, slot) registry
                claim_n[code] = len(rows)
                for slot, gid, is_l, _ in rows:
                    others = [(g2, cv) for s2, g2, _, cv in rows
                              if g2 != gid]
                    n_other = len(others)
                    moc = max((cv for _, cv in others), default=0.0)
                    own = gid >> _GID_SHIFT
                    mc = _f64(moc)
                    out[d][own].append((9, gid >> 32, gid & 0xFFFFFFFF,
                                        is_l, n_other, mc[0], mc[1]))
            self._claim_n[d] = claim_n
        inbox = self.ex.exchange(out)
        status: Dict[int, Dict[str, Tuple[int, float]]] = {}
        for d in range(n):
            for src in range(n):
                for m in inbox[d][src]:
                    _, g1, g2, is_l, n_other, m0, m1 = m[:7]
                    status.setdefault(_u64((g1, g2)), {})[
                        "L" if is_l else "R"] = (n_other, _unf64(m0, m1))
        return status

    def round(self, max_tip_len: int, min_cov: float, do_tips: bool,
              do_low_cov: bool, bubble_ratio: float = 0.25) -> int:
        n, k = self.n, self.k
        changed = 0

        status = self._end_statuses()

        # -- classify from the snapshot (mirrors clean._classify) --------
        out = self._empty_out()
        local_kill: List[Dict[int, bool]] = [dict() for _ in range(n)]
        for s in range(n):
            for gid, c in self.shards[s].contigs.items():
                if c.circular:
                    continue
                st = status.get(gid, {})
                eff = {e: v for e, v in st.items() if v[0] >= 1}
                n_eff = len(eff)
                L = len(c.seq)
                if n_eff == 0:
                    if do_low_cov and L < 3 * k \
                            and c.cov <= ISO_COV_MULT * min_cov:
                        local_kill[s][gid] = True
                elif n_eff == 1:
                    if do_tips and L < max_tip_len:
                        end, (n_other, moc) = next(iter(eff.items()))
                        if L >= 2 * k and c.cov >= TIP_KEEP_RATIO * moc:
                            continue
                        e = c.left if end == "L" else c.right
                        code = _node_code(e.node, k)
                        own = _owner_of_code(code, n)
                        hi, lo = _split64(code)
                        cv = _f64(c.cov)
                        rk = _split64(seq_rank64(c.canonical_seq()))
                        out[s][own].append((1, hi, lo, gid >> 32,
                                            gid & 0xFFFFFFFF, cv[0],
                                            cv[1], rk[0], rk[1], e.slot))
                else:
                    if do_low_cov and c.cov < min_cov:
                        local_kill[s][gid] = True
                    elif do_low_cov and bubble_ratio > 0 \
                            and L < max_tip_len:
                        # relative chimera rule (clean._classify): the
                        # END_STATUS moc fields are the strongest OTHER
                        # claim at each end — no extra exchange needed
                        mo = min(eff["L"][1], eff["R"][1])
                        if c.cov <= bubble_ratio * mo:
                            local_kill[s][gid] = True
                            self.chimeric += 1
        inbox = self.ex.exchange(out)

        # -- anchor arbitration (keep-strongest rule) -> kill verdicts ---
        out = self._empty_out()
        for d in range(n):
            by_node: Dict[int, List[Tuple]] = {}
            for src in range(n):
                for m in inbox[d][src]:
                    _, hi, lo, g1, g2, c0, c1, r0, r1, slot = m[:10]
                    by_node.setdefault(_u64((hi, lo)), []).append(
                        (_u64((g1, g2)), _unf64(c0, c1),
                         _u64((r0, r1)), slot))
            for code, cands in by_node.items():
                # snapshot claim count from this round's END_INFO pass
                # (mirrors _classify's `len(claims[node]) - len(js)`)
                total = self._claim_n[d].get(code, 0)
                others = total - len(cands)
                if others >= 1:
                    kill = [t[0] for t in cands]
                else:
                    keep = max(cands, key=lambda t: (t[1], t[2], t[3]))[0]
                    kill = [t[0] for t in cands if t[0] != keep]
                for gid in kill:
                    own = gid >> _GID_SHIFT
                    out[d][own].append((2, gid >> 32, gid & 0xFFFFFFFF))
        inbox = self.ex.exchange(out)

        # -- apply kills; port deletions to node owners ------------------
        out = self._empty_out()
        for s in range(n):
            kills = dict(local_kill[s])
            for src in range(n):
                for m in inbox[s][src]:
                    kills[_u64((m[1], m[2]))] = True
            for gid in kills:
                c = self.shards[s].contigs.pop(gid)
                self._drop_ports_msgs(gid, c, out)
                changed += 1
        self._apply_port_dels(self.ex.exchange(out))

        if do_low_cov and bubble_ratio > 0:
            nb = self._bubble_round(bubble_ratio)
            self.bubbles += nb
            changed += nb
        nr = self._repair_round()
        self.repaired += nr
        changed += nr
        changed += self._collapse_round()
        return changed

    def _repair_round(self) -> int:
        """Mirror of clean.repair_ports: every live contig asserts its
        ends (tag 12) to the node owner; the owner registers the
        strongest (cov, seq_rank64) claimant into each EMPTY slot —
        kills can orphan clash-hidden survivor ports, and collapse needs
        the repaired registry to see 1-1 nodes. Occupied slots are never
        touched (same setdefault-on-empty semantics as the sequential
        pass)."""
        n, k = self.n, self.k
        out = self._empty_out()
        for s in range(n):
            for gid, c in self.shards[s].contigs.items():
                for e, is_l in ((c.left, 1), (c.right, 0)):
                    if e is None:
                        continue
                    code = _node_code(e.node, k)
                    own = _owner_of_code(code, n)
                    hi, lo = _split64(code)
                    cv = _f64(c.cov)
                    rk = _split64(seq_rank64(c.canonical_seq()))
                    out[s][own].append((12, hi, lo, e.slot, gid >> 32,
                                        gid & 0xFFFFFFFF, cv[0], cv[1],
                                        rk[0], rk[1], is_l))
        inbox = self.ex.exchange(out)
        repaired = 0
        for d in range(n):
            cands: Dict[Tuple[int, int], List[Tuple]] = {}
            for src in range(n):
                for m in inbox[d][src]:
                    _, hi, lo, slot, g1, g2, c0, c1, r0, r1, is_l = m[:11]
                    code = _u64((hi, lo))
                    if slot in self.shards[d].ports.get(code, {}):
                        continue
                    cands.setdefault((code, slot), []).append(
                        (_unf64(c0, c1), _u64((r0, r1)),
                         _u64((g1, g2)), is_l))
            for (code, slot), rows in cands.items():
                cov, rk, gid, is_l = max(rows)
                self.shards[d].ports.setdefault(code, {})[slot] = (
                    gid, "L" if is_l else "R")
                repaired += 1
        return repaired

    def _bubble_round(self, ratio: float) -> int:
        """Relative-coverage bubble popping, partitioned: each JJ contig
        reports (node-pair and sides, clean.arm_key; cov, len, rank) to
        the pair's arbiter shard
        (owner of the smaller node code); the arbiter applies
        clean.pop_bubbles' FULL rule — (cov, seq_rank64) top-arm pick,
        `cov <= ratio*top` kill, and the EQLEN_RATIO equal-length kill —
        and returns kill verdicts. Survivors of popped groups then
        re-register their ports with setdefault semantics (two extra
        exchanges), matching the sequential pass's post-kill
        re-registration. cov rides as a float64 bit pattern, so
        thresholds match the sequential pass exactly."""
        n, k = self.n, self.k
        out = self._empty_out()
        for s in range(n):
            for gid, c in self.shards[s].contigs.items():
                if c.circular or c.left is None or c.right is None:
                    continue
                (na, sa), (nb, sb) = arm_key(c)
                ca, cb = _node_code(na, k), _node_code(nb, k)
                arb = _owner_of_code(min(ca, cb), n)
                ha, la = _split64(ca)
                hb, lb = _split64(cb)
                cv = _f64(c.cov)
                rk = _split64(seq_rank64(c.canonical_seq()))
                # the tag carries the two ends' sides (arm_key)
                out[s][arb].append((7 | sa << 4 | sb << 5, ha, la, hb, lb,
                                    cv[0], cv[1],
                                    gid >> 32, gid & 0xFFFFFFFF,
                                    len(c.seq), rk[0], rk[1]))
        inbox = self.ex.exchange(out)
        out = self._empty_out()
        for d in range(n):
            groups: Dict[Tuple[int, int, int], List[Tuple]] = {}
            for src in range(n):
                for m in inbox[d][src]:
                    tag, ha, la, hb, lb, c0, c1, g1, g2, ln, r0, r1 = m[:12]
                    groups.setdefault((_u64((ha, la)), _u64((hb, lb)),
                                       tag >> 4), []).append(
                        (_unf64(c0, c1), _u64((g1, g2)), ln,
                         _u64((r0, r1))))
            for arms in groups.values():
                if len(arms) < 2:
                    continue
                top_j = max(range(len(arms)),
                            key=lambda j: (arms[j][0], arms[j][3]))
                top = arms[top_j][0]
                top_len = arms[top_j][2]
                g_kill = [gid for j, (cov, gid, ln, _) in enumerate(arms)
                          if j != top_j and (
                              cov <= ratio * top
                              or (ln == top_len
                                  and cov <= EQLEN_RATIO * top))]
                for gid in g_kill:
                    own = gid >> _GID_SHIFT
                    out[d][own].append((2, gid >> 32, gid & 0xFFFFFFFF))
                if g_kill:
                    for cov, gid, ln, _ in arms:
                        if gid not in g_kill:
                            own = gid >> _GID_SHIFT
                            out[d][own].append((10, gid >> 32,
                                                gid & 0xFFFFFFFF))
        inbox = self.ex.exchange(out)
        out = self._empty_out()
        killed = 0
        survivors: List[List[int]] = [[] for _ in range(n)]
        for s in range(n):
            gids = {_u64((m[1], m[2])) for src in range(n)
                    for m in inbox[s][src] if m[0] == 2}
            for gid in gids:
                c = self.shards[s].contigs.pop(gid)
                self._drop_ports_msgs(gid, c, out)
                killed += 1
            survivors[s] = [
                _u64((m[1], m[2])) for src in range(n)
                for m in inbox[s][src]
                if m[0] == 10 and _u64((m[1], m[2])) not in gids]
        self._apply_port_dels(self.ex.exchange(out))
        # survivor re-registration (setdefault at the node owner)
        out = self._empty_out()
        for s in range(n):
            for gid in survivors[s]:
                c = self.shards[s].contigs.get(gid)
                if c is None:
                    continue
                for e, is_l in ((c.left, 1), (c.right, 0)):
                    if e is None:
                        continue
                    code = _node_code(e.node, self.k)
                    own = _owner_of_code(code, self.n)
                    hi, lo = _split64(code)
                    out[s][own].append((11, hi, lo, e.slot, gid >> 32,
                                        gid & 0xFFFFFFFF, is_l))
        inbox = self.ex.exchange(out)
        for d in range(n):
            for src in range(n):
                for m in inbox[d][src]:
                    _, hi, lo, slot, g1, g2, is_l = m[:7]
                    code = _u64((hi, lo))
                    self.shards[d].ports.setdefault(code, {}).setdefault(
                        slot, (_u64((g1, g2)), "L" if is_l else "R"))
        return killed

    # ---- collapse with per-contig conflict resolution -------------------
    def _collapse_round(self) -> int:
        n, k = self.n, self.k
        # node owners propose merges for 2-port opposite-face nodes
        proposals = []  # (node_owner, code, (rslot, gid_r, end_r),
        #                 (lslot, gid_l, end_l))
        for d in range(n):
            for code, dslot in self.shards[d].ports.items():
                if len(dslot) != 2:
                    continue
                slots = sorted(dslot)
                if not (slots[0] < 4 <= slots[1]):
                    continue
                (g1, e1) = dslot[slots[0]]
                (g2, e2) = dslot[slots[1]]
                proposals.append((d, code, (slots[0], g1, e1),
                                  (slots[1], g2, e2)))
        # conflict resolution: a contig joins at most one merge per
        # round; the proposal with the smallest (hash-ordered) node code
        # wins. Deterministic and shard-independent: route each proposal
        # to both contigs' owners, owners pick the minimum-code proposal
        # per contig, and a proposal proceeds iff it won at BOTH contigs.
        out = self._empty_out()
        for (d, code, (rs, gr, er), (ls, gl, el)) in proposals:
            hi, lo = _split64(code)
            for gid in {gr, gl}:
                own = gid >> _GID_SHIFT
                out[d][own].append((4, hi, lo, d, rs, gr >> 32,
                                    gr & 0xFFFFFFFF))
                # second contig rides a paired row
                out[d][own].append((5, hi, lo, d, ls, gl >> 32,
                                    gl & 0xFFFFFFFF))
        inbox = self.ex.exchange(out)
        # contig owners: pick min-code proposal per contig
        best: Dict[int, int] = {}   # gid -> chosen node code
        props: Dict[int, Tuple] = {}  # code -> full proposal
        for d in range(n):
            rows = [m for src in range(n) for m in inbox[d][src]]
            cur: Dict[int, list] = {}
            for m in rows:
                tag, hi, lo, owner, slot, g1, g2 = m[:7]
                code = _u64((hi, lo))
                cur.setdefault(code, [None, None, None])[0 if tag == 4
                                                         else 1] = \
                    (slot, _u64((g1, g2)))
                cur[code][2] = owner
            for code, (r, l, owner) in cur.items():
                if r is None or l is None:
                    continue
                props[code] = (owner, code, r, l)
                for gid in {r[1], l[1]}:
                    if gid >> _GID_SHIFT != d:
                        continue
                    if gid not in self.shards[d].contigs:
                        continue
                    if gid not in best or code < best[gid]:
                        best[gid] = code
        # acceptance: proposal proceeds iff it is the winner at every
        # involved contig (computed host-globally here — the per-shard
        # votes are already consistent because `best` is per-contig)
        done = 0
        for code, (owner, _, (rs, gr), (ls, gl)) in sorted(props.items()):
            if best.get(gr) != code or best.get(gl) != code:
                continue
            if self._merge(owner, code, rs, gr, ls, gl):
                done += 1
        return done

    def _take_contig(self, gid: int, to_shard: int) -> Contig:
        src = gid >> _GID_SHIFT
        c = self.shards[src].contigs.pop(gid)
        if src != to_shard:
            self.payload_bytes += len(c.seq) + 64
        return c

    def _merge(self, node_owner: int, code: int, rslot: int, gid_r: int,
               lslot: int, gid_l: int) -> bool:
        """Replicates ContigGraph.merge_through on partitioned state.
        The merged contig lands on the node owner's shard (it arbitrated
        the merge); its far-end ports re-register at their owners."""
        k = self.k
        dslot = self.shards[node_owner].ports.get(code)
        if not dslot or rslot not in dslot or lslot not in dslot:
            return False
        (g1, e1) = dslot[rslot]
        (g2, e2) = dslot[lslot]
        assert g1 == gid_r and g2 == gid_l
        if gid_r == gid_l:
            c = self._take_contig(gid_r, node_owner)
            right_part = c.seq if e1 == "L" else revcomp_seq(c.seq)
            del self.shards[node_owner].ports[code]
            merged = Contig(seq=right_part[:-k], cov=c.cov, circular=True)
            self.shards[node_owner].contigs[
                self._new_gid(node_owner)] = merged
            return True
        c1 = self._take_contig(gid_r, node_owner)
        c2 = self._take_contig(gid_l, node_owner)
        right_seq = c1.seq if e1 == "L" else revcomp_seq(c1.seq)
        right_far = c1.right if e1 == "L" else c1.left
        left_seq = c2.seq if e2 == "R" else revcomp_seq(c2.seq)
        left_far = c2.left if e2 == "R" else c2.right
        n1 = len(c1.seq) - k + 1
        n2 = len(c2.seq) - k + 1
        cov = (c1.cov * n1 + c2.cov * n2) / max(n1 + n2, 1)
        merged = Contig(seq=left_seq + right_seq[k:], cov=cov,
                        left=left_far, right=right_far)
        # slot-precise deletion: collapse consumes the whole 2-port
        # node, but a disentangle merge (merge_through analogue) leaves
        # the node's OTHER pair in place for the second merge
        del dslot[rslot]
        del dslot[lslot]
        if not dslot:
            del self.shards[node_owner].ports[code]
        gid = self._new_gid(node_owner)
        self.shards[node_owner].contigs[gid] = merged
        # far-end ports move from the absorbed contigs to the merged one
        out = self._empty_out()
        for e, end, old_gid in ((left_far, "L", gid_l),
                                (right_far, "R", gid_r)):
            if e is None:
                continue
            fcode = _node_code(e.node, k)
            fown = _owner_of_code(fcode, self.n)
            hi, lo = _split64(fcode)
            out[node_owner][fown].append((6, hi, lo, e.slot, gid >> 32,
                                          gid & 0xFFFFFFFF, end == "L"))
        inbox = self.ex.exchange(out)
        for d in range(self.n):
            for src in range(self.n):
                for m in inbox[d][src]:
                    _, hi, lo, slot, g1, g2, is_l = m[:7]
                    fcode = _u64((hi, lo))
                    self.shards[d].ports.setdefault(fcode, {})[slot] = (
                        _u64((g1, g2)), "L" if is_l else "R")
        return True

    # ---- paired-end disentangle (VERDICT r4 #7) --------------------------
    def _far_info(self) -> List[Dict[int, Dict[int, int]]]:
        """FAR_INFO pass (tag 13): node owners learn the far-end node
        CODE behind every registered port. Contig owners send, per
        attached end, (node, slot, gid, far_code|none); the node owner
        keeps rows matching its registry entry (the sequential far()
        also reads through the registry, clean.disentangle). Returns
        per shard: {node_code: {slot: far_code or -1}}."""
        n, k = self.n, self.k
        out = self._empty_out()
        for s in range(n):
            for gid, c in self.shards[s].contigs.items():
                if c.circular:
                    continue
                for e, other in ((c.left, c.right), (c.right, c.left)):
                    if e is None:
                        continue
                    code = _node_code(e.node, k)
                    own = _owner_of_code(code, n)
                    hi, lo = _split64(code)
                    if other is not None:
                        fhi, flo = _split64(_node_code(other.node, k))
                        hf = 1
                    else:
                        fhi = flo = 0
                        hf = 0
                    out[s][own].append((13, hi, lo, e.slot, gid >> 32,
                                        gid & 0xFFFFFFFF, fhi, flo, hf))
        inbox = self.ex.exchange(out)
        far: List[Dict[int, Dict[int, int]]] = [{} for _ in range(n)]
        for d in range(n):
            for src in range(n):
                for m in inbox[d][src]:
                    _, hi, lo, slot, g1, g2, fhi, flo, hf = m[:9]
                    code = _u64((hi, lo))
                    reg = self.shards[d].ports.get(code, {}).get(slot)
                    if reg is None or reg[0] != _u64((g1, g2)):
                        continue
                    far[d].setdefault(code, {})[slot] = (
                        _u64((fhi, flo)) if hf else -1)
        return far

    def _pc_codes(self, pair_count):
        """Adapt the sequential string pair_count to node codes."""
        from faucet_tpu_torch.core.kmer import decode_kmer

        k = self.k

        def pc(a: int, b: int, *exclude: int) -> int:
            if a < 0 or b < 0 or a in exclude or b in exclude:
                return 0
            return pair_count(
                decode_kmer(a >> 32, a & 0xFFFFFFFF, k),
                decode_kmer(b >> 32, b & 0xFFFFFFFF, k))

        return pc

    def _disentangle_nodes(self, pc, min_pairs: int,
                           cross_max: int) -> int:
        """2-in/2-out repeat nodes (mirror of clean.disentangle's node
        loop): the node owner holds the 4-port registry, FAR_INFO gives
        it the far codes, and the (replicated) pair store supplies the
        evidence; a unique in->out matching becomes TWO merges issued as
        one transaction — per-contig min-code voting (the collapse
        round's conflict rule) gates both merges together so a contig
        joins at most one transaction per pass."""
        n = self.n
        far = self._far_info()
        props: Dict[int, Tuple] = {}
        for d in range(n):
            for code, dslot in self.shards[d].ports.items():
                if len(dslot) != 4:
                    continue
                rs = sorted(s for s in dslot if s < 4)
                ls = sorted(s for s in dslot if s >= 4)
                if len(rs) != 2 or len(ls) != 2:
                    continue
                if len({dslot[s][0] for s in rs + ls}) != 4:
                    continue
                f = {s: far[d].get(code, {}).get(s, -1) for s in rs + ls}
                c11 = pc(f[ls[0]], f[rs[0]], code)
                c12 = pc(f[ls[0]], f[rs[1]], code)
                c21 = pc(f[ls[1]], f[rs[0]], code)
                c22 = pc(f[ls[1]], f[rs[1]], code)
                if (c11 >= min_pairs and c22 >= min_pairs
                        and c12 <= cross_max and c21 <= cross_max):
                    pairs = [(rs[0], ls[0]), (rs[1], ls[1])]
                elif (c12 >= min_pairs and c21 >= min_pairs
                        and c11 <= cross_max and c22 <= cross_max):
                    pairs = [(rs[1], ls[0]), (rs[0], ls[1])]
                else:
                    continue
                props[code] = (d, pairs,
                               {s: dslot[s][0] for s in rs + ls})
        # per-contig voting (tag 14 to each contig owner; acceptance
        # computed host-globally like _collapse_round's)
        out = self._empty_out()
        for code, (d, pairs, gids) in props.items():
            hi, lo = _split64(code)
            for slot, gid in gids.items():
                own = gid >> _GID_SHIFT
                out[d][own].append((14, hi, lo, slot, gid >> 32,
                                    gid & 0xFFFFFFFF))
        inbox = self.ex.exchange(out)
        best: Dict[int, int] = {}
        for d in range(n):
            for src in range(n):
                for m in inbox[d][src]:
                    _, hi, lo, slot, g1, g2 = m[:6]
                    gid = _u64((g1, g2))
                    if gid >> _GID_SHIFT != d \
                            or gid not in self.shards[d].contigs:
                        continue
                    code = _u64((hi, lo))
                    if gid not in best or code < best[gid]:
                        best[gid] = code
        resolved = 0
        for code in sorted(props):
            d, pairs, gids = props[code]
            if any(best.get(gid) != code for gid in gids.values()):
                continue
            dslot = self.shards[d].ports.get(code, {})
            if any(dslot.get(s, (None,))[0] != g
                   for s, g in gids.items()):
                continue
            ok = True
            for rslot, lslot in pairs:
                gr = dslot[rslot][0]
                gl = dslot[lslot][0]
                ok = self._merge(d, code, rslot, gr, lslot, gl) and ok
            # mirrors the reference's fault (ROADMAP.md C2): `ok` is not
            # read, so a node counts as resolved even when a merge of it
            # was refused (tests/test_torch_dist_halo.py shows it)
            resolved += 1
        return resolved

    def _disentangle_chains(self, pc, min_pairs: int,
                            cross_max: int) -> int:
        """Repeat CONTIGS between two 3-port nodes (mirror of
        clean._disentangle_chains): each 3-port node owner sends its
        two flank ports (tag 15, with far codes and end orientations)
        to the lone-face contig's owner; that owner joins the two
        halves, evaluates the pair evidence, and splices A-R-B / C-R-D,
        pulling the flank payloads on the host object plane (the same
        discipline as _merge) and re-registering the new far ports
        (tag 6). Greedy host-global acceptance in gid order stands in
        for the sequential pass's live()-order iteration."""
        n, k = self.n, self.k
        far = self._far_info()
        out = self._empty_out()
        for d in range(n):
            for code, dslot in self.shards[d].ports.items():
                if len(dslot) != 3:
                    continue
                rface = sorted(s for s in dslot if s < 4)
                lface = sorted(s for s in dslot if s >= 4)
                lone, flanks = (rface, lface) if len(rface) == 1 \
                    else (lface, rface)
                if len(lone) != 1 or len(flanks) != 2:
                    continue
                rgid, rend = dslot[lone[0]]
                hi, lo = _split64(code)
                own = rgid >> _GID_SHIFT
                for fs in flanks:
                    fgid, fend = dslot[fs]
                    fcode = far[d].get(code, {}).get(fs, -1)
                    fhi, flo = _split64(fcode if fcode >= 0 else 0)
                    flags = ((1 if fcode >= 0 else 0)
                             | ((fend == "L") << 1)
                             | ((rend == "L") << 2))
                    out[d][own].append((15, rgid >> 32,
                                        rgid & 0xFFFFFFFF, hi, lo,
                                        lone[0], fgid >> 32,
                                        fgid & 0xFFFFFFFF, fs, fhi,
                                        flo, flags))
        inbox = self.ex.exchange(out)
        # R owners: join halves per R gid
        halves: Dict[int, Dict[int, List[Tuple]]] = {}
        for d in range(n):
            for src in range(n):
                for m in inbox[d][src]:
                    (_, rg1, rg2, hi, lo, rslot, fg1, fg2, fs, fhi,
                     flo, flags) = m[:12]
                    rgid = _u64((rg1, rg2))
                    if rgid >> _GID_SHIFT != d:
                        continue
                    halves.setdefault(rgid, {}).setdefault(
                        _u64((hi, lo)), []).append(
                        (fs, _u64((fg1, fg2)),
                         _u64((fhi, flo)) if flags & 1 else -1,
                         "L" if flags & 2 else "R", rslot,
                         "L" if flags & 4 else "R"))
        resolved = 0
        touched: set = set()
        for rgid in sorted(halves):
            d = rgid >> _GID_SHIFT
            R = self.shards[d].contigs.get(rgid)
            if R is None or R.circular or R.left is None \
                    or R.right is None or rgid in touched:
                continue
            x = _node_code(R.left.node, k)
            y = _node_code(R.right.node, k)
            if x == y or x not in halves[rgid] or y not in halves[rgid]:
                continue
            hx = sorted(halves[rgid][x])
            hy = sorted(halves[rgid][y])
            if len(hx) != 2 or len(hy) != 2:
                continue
            (sa, ga, fa, ea, _, _), (sc, gc, fc, ec, _, _) = hx
            (sb, gb, fb, eb, _, _), (sd, gd, fd, ed, _, _) = hy
            ids = {rgid, ga, gc, gb, gd}
            if len(ids) != 5 or ids & touched:
                continue
            ab = pc(fa, fb, x, y)
            ad = pc(fa, fd, x, y)
            cb = pc(fc, fb, x, y)
            cd = pc(fc, fd, x, y)
            if ab >= min_pairs and cd >= min_pairs \
                    and ad <= cross_max and cb <= cross_max:
                matching = [((sa, ga, ea), (sb, gb, eb)),
                            ((sc, gc, ec), (sd, gd, ed))]
            elif ad >= min_pairs and cb >= min_pairs \
                    and ab <= cross_max and cd <= cross_max:
                matching = [((sa, ga, ea), (sd, gd, ed)),
                            ((sc, gc, ec), (sb, gb, eb))]
            else:
                continue
            if self._splice_chain(d, rgid, R, x, y, matching):
                touched |= ids
                resolved += 1
        return resolved

    def _splice_chain(self, d: int, rgid: int, R: Contig, x: int,
                      y: int, matching) -> bool:
        """Execute one A-R-B / C-R-D chain splice on R's owner shard."""
        k = self.k
        # orient R with x at its left end (R.left is the x End by
        # construction in _disentangle_chains)
        r_seq = R.seq
        new_contigs = []
        pulls = []
        for (sa, ga, ea), (sb, gb, eb) in matching:
            ca = self._peek_contig(ga)
            cb2 = self._peek_contig(gb)
            if ca is None or cb2 is None:
                return False
            a_seq = ca.seq if ea == "R" else revcomp_seq(ca.seq)
            a_far = ca.left if ea == "R" else ca.right
            b_seq = cb2.seq if eb == "L" else revcomp_seq(cb2.seq)
            b_far = cb2.right if eb == "L" else cb2.left
            if a_seq[-k:] != r_seq[:k] or r_seq[-k:] != b_seq[:k]:
                return False
            n_a = len(ca.seq) - k + 1
            n_b = len(cb2.seq) - k + 1
            n_r = len(R.seq) - k + 1
            cov = (ca.cov * n_a + cb2.cov * n_b + R.cov * n_r) / (
                n_a + n_b + n_r)
            new_contigs.append(Contig(seq=a_seq + r_seq[k:] + b_seq[k:],
                                      cov=cov, left=a_far, right=b_far))
            pulls.extend((ga, gb))
        # commit: pull + delete the five old contigs and their ports
        out = self._empty_out()
        for gid in pulls:
            c = self._take_contig(gid, d)
            self._drop_ports_msgs(gid, c, out)
        c = self.shards[d].contigs.pop(rgid)
        self._drop_ports_msgs(rgid, c, out)
        self._apply_port_dels(self.ex.exchange(out))
        out = self._empty_out()
        for nc in new_contigs:
            gid = self._new_gid(d)
            self.shards[d].contigs[gid] = nc
            for e, is_l in ((nc.left, 1), (nc.right, 0)):
                if e is None:
                    continue
                fcode = _node_code(e.node, k)
                fown = _owner_of_code(fcode, self.n)
                hi, lo = _split64(fcode)
                out[d][fown].append((6, hi, lo, e.slot, gid >> 32,
                                     gid & 0xFFFFFFFF, is_l))
        inbox = self.ex.exchange(out)
        for dd in range(self.n):
            for src in range(self.n):
                for m in inbox[dd][src]:
                    _, hi, lo, slot, g1, g2, is_l = m[:7]
                    self.shards[dd].ports.setdefault(
                        _u64((hi, lo)), {})[slot] = (
                        _u64((g1, g2)), "L" if is_l else "R")
        return True

    def _peek_contig(self, gid: int) -> Optional[Contig]:
        return self.shards[gid >> _GID_SHIFT].contigs.get(gid)

    def disentangle(self, pair_count, min_pairs: int = 2,
                    cross_max: int = 0) -> int:
        """Partitioned mirror of clean.disentangle (nodes then chains).
        pair_count: the sequential (kmer_str, kmer_str) -> count
        callable; the pair store is replicated host state in this
        prototype, matching its host-dict form in the pipeline."""
        pc = self._pc_codes(pair_count)
        done = self._disentangle_nodes(pc, min_pairs, cross_max)
        done += self._disentangle_chains(pc, min_pairs, cross_max)
        return done

    # ---- driver ----------------------------------------------------------
    def clean(self, max_tip_len: int = 200, min_cov: float = 2.5,
              do_tips: bool = True, do_low_cov: bool = True,
              max_rounds: int = 64, bubble_ratio: float = 0.25,
              pair_count=None, min_pairs: int = 2) -> dict:
        rounds = 0
        disentangled = 0

        def fixpoint():
            nonlocal rounds
            for _ in range(max_rounds):
                ch = self.round(max_tip_len, min_cov, do_tips,
                                do_low_cov, bubble_ratio)
                rounds += 1
                # global fixpoint: `ch` is already the cross-shard total
                # (the host loop IS the pmax — every shard contributed)
                if ch == 0:
                    break

        fixpoint()
        if pair_count is not None:
            disentangled = self.disentangle(pair_count,
                                            min_pairs=min_pairs)
            if disentangled:
                fixpoint()
        return {"rounds": rounds, "exchanges": self.ex.rounds,
                "bubbles": self.bubbles, "chimeric": self.chimeric,
                "repaired": self.repaired,
                "disentangled": disentangled,
                "collective_bytes": self.ex.bytes,
                "payload_bytes": self.payload_bytes}

    def result(self) -> ContigGraph:
        g = ContigGraph(self.k)
        for s in self.shards:
            for c in s.contigs.values():
                g.add_contig(c)
        return g
