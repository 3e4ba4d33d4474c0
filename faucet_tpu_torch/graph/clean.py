# Host code copied verbatim from faucet_tpu/graph/clean.py; only the imports point
# at faucet_tpu_torch, whose modules import no jax.
"""Graph cleaning passes over the host-side compacted graph.

Reference analogue: ContigGraph's cleaning pipeline — deleteTipsAndClean,
low-coverage/chimeric deletion, collapseDummyNodes, Bloom-FP pruning
(ref:src/ContigGraph.cpp, SURVEY.md §2.1 [C:high], §A.7). Passes iterate
to a fixpoint, then paired-end disentanglement runs once (§A.7e).

Note on FP pruning: in this design Bloom false positives can only create
(a) extra 1-in/1-out junction nodes — removed by collapse; (b) cov-0 slots
— never walked; (c) FP tails past dead ends — trimmed at walk time by the
recorded dist/caps. So "FP pruning" is structural here rather than a
separate pass (SURVEY.md §7.1 divergence note).

Scale (VERDICT r1 #8): the delete passes (tips, chimeras, islands) —
the bulk of every round's work — classify from ONE round-start snapshot
(`_classify`) and apply kills together (`_delete_round`); snapshot
semantics make the host pass, the scalar passes, and the partitioned
halo cleaner provably agree (including the per-anchor keep-strongest-tip
rule). Node collapse walks
the 1-1 node list once per round. Distributed pre-cleaning for
metagenome-scale graphs: the sharded pipeline can prune junction slots
below a coverage floor on device BEFORE walking (dist/sharded.py
prune_slots, a shard-local pass over the hash-range-owned table), which
shrinks the extracted graph by the same contigs these host passes would
delete; the full halo-exchange design is documented in PARITY.md §config5.
"""
from __future__ import annotations

import numpy as np

from faucet_tpu_torch.graph.model import ContigGraph


TIP_KEEP_RATIO = 0.8   # tips >= 2k keeping >= ratio x the anchor's
#                        strongest other arm are real coverage (e.g.
#                        genome-terminal stubs cut off by a spurious
#                        junction) and survive the length rule
ISO_COV_MULT = 2.0     # isolated-contig cov is an end-ANCHOR count
#                        (~2 anchors per read), not a depth: the kill
#                        threshold doubles accordingly


def _claims(g: ContigGraph):
    """node -> [(ci, end, slot)]: EVERY live contig end referencing the
    node, independent of the port registry. The registry is lossy —
    (node, slot) registration is last-writer-wins, so a clash hides one
    claimant, and removing the registered claimant orphans the other.
    Classification decisions must come from this ground-truth view or
    true segments flanked by clash-hidden ports look dangling and get
    killed as tips (the round-4 Mbp-scale break mode: contigs 850/1717
    in bench/diagnose_breaks, each killed at cov 13-23x)."""
    m = {}
    for i in g.live():
        c = g.contigs[i]
        for e, end in ((c.left, "L"), (c.right, "R")):
            if e is not None:
                m.setdefault(e.node, []).append((i, end, e.slot))
    return m


def _eff_ends(g: ContigGraph, i: int, claims=None):
    """Effective attachment of contig i's two ends (round-4 rule).

    An end whose node carries NO other live contig end is DANGLING — the
    "junction" exists only because this contig ends there (a ghost node:
    Bloom-fp/error junction whose other arms were cleaned away, or a
    port-clash surgery remnant). Dangling ends classify as open, which
    is what lets the tip/isolated rules see through ghost nodes — the
    round-3 Mbp-scale failure mode (every surviving error contig at
    1 Mbp had a degree-1 ghost node on one end; bench/diagnose_breaks).
    Attachment counts CLAIMS (contig End records), not registry ports —
    see _claims.

    Returns (eff_left, eff_right): each None or the End."""
    if claims is None:
        claims = _claims(g)
    c = g.contigs[i]
    out = []
    for e in (c.left, c.right):
        if e is None:
            out.append(None)
            continue
        n_other = sum(1 for ci, _, _ in claims.get(e.node, ())
                      if ci != i)
        out.append(e if n_other >= 1 else None)
    return out[0], out[1]


def _classify(g: ContigGraph, max_tip_len: int, min_cov: float,
              do_tips: bool, do_low_cov: bool,
              chim_ratio: float = 0.0):
    """ONE-SNAPSHOT classification of the three delete rules. All kill
    sets are computed from the round-start state (no mutation-order
    dependence), which is what makes the vectorized host pass, the
    scalar passes, and the partitioned halo cleaner provably agree
    (tests/unit/test_cleanvec.py, tests/dist/test_halo.py).

    Rules (SURVEY.md §A.7a/b; reference deleteTipsAndClean +
    removeChimericExtensions, ref:src/ContigGraph.cpp [C:med]):
      TIP      exactly one effectively-attached end, len < max_tip_len.
               Tips >= 2k bases also need cov < TIP_KEEP_RATIO x the
               anchor's strongest other arm (a high-cov long stub is
               real sequence, not an error path). Per anchor, if
               killing every candidate would strip the node bare, the
               strongest candidate (cov, then seq_rank64, then slot)
               survives.
      LOW-COV  both ends effectively attached, cov < min_cov; OR (the
               RELATIVE chimera rule, reference
               removeChimericExtensions, SURVEY.md §A.7b): len <
               max_tip_len and cov <= chim_ratio x the strongest OTHER
               claim at EACH end. Error paths that skip a junction run
               parallel to a multi-contig true path, so pop_bubbles'
               same-node-pair grouping never sees them, and at ~2
               occurrences they sit exactly AT the absolute min_cov
               floor (strict <) — the relative rule keys on the 10x
               coverage gap to the flanking true arms instead. The
               length guard keeps unique low-copy regions between
               high-copy repeats alive.
      ISOLATED no effectively-attached end, len < 3k,
               cov <= ISO_COV_MULT * min_cov (INCLUSIVE: the dominant
               island class — a doubled error k-mer seen exactly twice
               — yields exactly 2 anchors x 2 reads = 4.0 end-anchors,
               exactly AT the default 2 x 2.0 threshold).

    Returns (tip_idxs, lowcov_idxs, chimeric_idxs, iso_idxs) as lists
    of graph indices.
    """
    k = g.k
    lowcov, chim, iso = [], [], []
    tip_cand = {}  # anchor node -> [(idx, cov, rank, slot)]
    claims = _claims(g)
    for i in g.live():
        c = g.contigs[i]
        if c.circular:
            continue
        el, er = _eff_ends(g, i, claims)
        n_eff = (el is not None) + (er is not None)
        L = len(c.seq)
        if n_eff == 0:
            if do_low_cov and L < 3 * k \
                    and c.cov <= ISO_COV_MULT * min_cov:
                iso.append(i)
        elif n_eff == 1:
            if do_tips and L < max_tip_len:
                e = el if el is not None else er
                if L >= 2 * k:
                    mo = max(g.contigs[ci].cov for ci, _, _
                             in claims[e.node] if ci != i)
                    if c.cov >= TIP_KEEP_RATIO * mo:
                        continue
                tip_cand.setdefault(e.node, []).append(
                    (i, c.cov, seq_rank64(c.canonical_seq()), e.slot))
        else:
            if do_low_cov and c.cov < min_cov:
                lowcov.append(i)
            elif do_low_cov and chim_ratio > 0 and L < max_tip_len:
                sa = max((g.contigs[ci].cov for ci, _, _
                          in claims[el.node] if ci != i), default=0.0)
                sb = max((g.contigs[ci].cov for ci, _, _
                          in claims[er.node] if ci != i), default=0.0)
                if c.cov <= chim_ratio * min(sa, sb):
                    chim.append(i)
    tips = []
    for node, js in tip_cand.items():
        others = len(claims[node]) - len(js)
        if others >= 1:
            tips.extend(i for i, _, _, _ in js)
        else:
            keep = max(js, key=lambda t: (t[1], t[2], t[3]))[0]
            tips.extend(i for i, _, _, _ in js if i != keep)
    return sorted(tips), lowcov, chim, iso


def clip_tips(g: ContigGraph, max_tip_len: int) -> int:
    """Delete short dead-end stubs (snapshot semantics: see _classify)."""
    tips, _, _, _ = _classify(g, max_tip_len, 0.0, True, False)
    for i in tips:
        g.remove_contig(i)
    return len(tips)


def drop_low_cov(g: ContigGraph, min_cov: float) -> int:
    """Delete low-coverage contigs bridging junctions (chimeras)."""
    _, lowcov, _, _ = _classify(g, 0, min_cov, False, True)
    for i in lowcov:
        g.remove_contig(i)
    return len(lowcov)


def drop_short_isolated(g: ContigGraph, min_cov: float) -> int:
    """Delete tiny isolated linear contigs (doubled-error islands): no
    effectively-attached end, shorter than 3k, at or below ISO_COV_MULT
    x the cov threshold (isolated cov is an end-anchor count ~2x read
    depth). Long isolated contigs (plasmids, junction-free components)
    are kept regardless of cov."""
    _, _, _, iso = _classify(g, 0, min_cov, False, True)
    for i in iso:
        g.remove_contig(i)
    return len(iso)


def _delete_round(g: ContigGraph, max_tip_len: int, min_cov: float,
                  do_tips: bool, do_low_cov: bool,
                  chim_ratio: float = 0.0):
    """One snapshot round of the three delete rules (_classify), kills
    applied together after classification. Differential-tested against
    an independent reference classifier in tests/unit/test_cleanvec.py."""
    tips, lowcov, chim, iso = _classify(g, max_tip_len, min_cov,
                                        do_tips, do_low_cov, chim_ratio)
    for i in tips:
        g.remove_contig(i)
    for i in lowcov:
        g.remove_contig(i)
    for i in chim:
        g.remove_contig(i)
    for i in iso:
        g.remove_contig(i)
    return len(tips), len(lowcov), len(chim), len(iso)


def repair_ports(g: ContigGraph) -> int:
    """Re-register orphaned contig ends into EMPTY registry slots.

    (node, slot) registration is last-writer-wins; when the registered
    claimant of a clashed slot is removed (a tip kill, a bubble pop, a
    port-clash containment drop), the surviving claimant's end is left
    unregistered — the node looks one-ported, collapse can't fire, and
    the next classify round misreads attachment. Runs after each kill
    phase; where several orphans claim one empty slot (a still-live
    clash), the strongest (cov, seq_rank64) claimant registers — a
    content-based order the partitioned cleaner (dist/halo.py) can
    replicate without graph indices. Occupied slots are never touched."""
    by_slot = {}
    for i in g.live():
        c = g.contigs[i]
        for e, end in ((c.left, "L"), (c.right, "R")):
            if e is None:
                continue
            d = g.ports.get(e.node, {})
            if e.slot not in d:
                by_slot.setdefault((e.node, e.slot), []).append(
                    (c.cov, seq_rank64(c.canonical_seq()), i, end))
    n = 0
    for (node, slot), cands in by_slot.items():
        cov, rk, i, end = max(cands)
        g.ports.setdefault(node, {})[slot] = (i, end)
        n += 1
    return n


def resolve_port_clashes(g: ContigGraph) -> int:
    """Repair walks that merged in sequence space: when >=2 contigs claim
    the SAME (node, slot) port, they share their entire tail (same last
    k+1 bases, by the port definition), which means a junction at their
    divergence point went unrecorded (a B false positive shadowed the
    edge's new_b promotion — core/nodes.py docstring). Registration is
    last-writer-wins, so the clash silently orphans one contig and blocks
    collapse.

    Surgery: orient all claimants clash-end-right, find their longest
    common suffix S, and rebuild the missing junction X* = first window
    of S — one tail contig S (cov = claimants' sum) plus one arm per
    claimant, each re-attached to X* via its own divergent entry base.
    Error bubbles then become short parallel arms that pop_bubbles
    removes; genuine repeat convergences keep both arms and a correct
    junction. Runs to fixpoint (arms can still clash pairwise when >2
    claimants share divergence bases)."""
    from faucet_tpu_torch.core.kmer import revcomp_seq
    from faucet_tpu_torch.core.slots import entry_slot, exit_slot
    from faucet_tpu_torch.graph.model import Contig, End

    k = g.k
    fixed = 0
    _B = {"A": 0, "C": 1, "G": 2, "T": 3}
    while True:
        claim = {}
        for i in g.live():
            c = g.contigs[i]
            if c.circular:
                continue
            for e, end in ((c.left, "L"), (c.right, "R")):
                if e is not None:
                    claim.setdefault((e.node, e.slot), []).append((i, end))
        progressed = False
        for (node, slot), lst in claim.items():
            lst = [(i, end) for (i, end) in lst
                   if not g.contigs[i].deleted]
            if len(lst) < 2:
                continue
            oriented = []
            for i, end in lst:
                c = g.contigs[i]
                if end == "R":
                    oriented.append((i, c.seq, c.left))
                else:
                    oriented.append((i, revcomp_seq(c.seq), c.right))
            minlen = min(len(s) for _, s, _ in oriented)
            s0 = oriented[0][1]
            L = minlen
            for _, s, _ in oriented[1:]:
                m = 0
                while m < L and s0[-1 - m] == s[-1 - m]:
                    m += 1
                L = min(L, m)
            if L >= minlen or L < k + 1:
                # containment: the shortest claimant IS a piece of the
                # shared tail (a walk over the same edge that died early
                # — trim/ambiguity) — drop it, keep the longer walks.
                # Degenerate (< k+1 overlap) clashes take the same path.
                shortest = min(oriented,
                               key=lambda t: (len(t[1]),
                                              g.contigs[t[0]].cov, t[1]))
                g.remove_contig(shortest[0])
                # removing the REGISTERED claimant would orphan the
                # survivors (last-writer-wins registry): re-register the
                # strongest remaining claimant at the clashed port
                rest = [(i, end) for (i, end) in lst
                        if i != shortest[0] and not g.contigs[i].deleted]
                if rest and slot not in g.ports.get(node, {}):
                    best = max(rest, key=lambda t: (
                        g.contigs[t[0]].cov,
                        seq_rank64(g.contigs[t[0]].canonical_seq())))
                    g.ports.setdefault(node, {})[slot] = best
                fixed += 1
                progressed = True
                continue
            S = s0[-L:]
            W = S[:k]
            Xs = min(W, revcomp_seq(W))
            w_canon = W == Xs
            covT = sum(g.contigs[i].cov for i, _, _ in oriented)
            tail = Contig(seq=S, cov=covT,
                          left=End(Xs, exit_slot(w_canon, _B[S[k]])),
                          right=End(node, slot))
            arms = []
            for i, s, far in oriented:
                es = entry_slot(w_canon, _B[s[len(s) - L - 1]])
                arms.append(Contig(seq=s[: len(s) - L + k],
                                   cov=g.contigs[i].cov, left=far,
                                   right=End(Xs, es)))
            for i, _, _ in oriented:
                g.remove_contig(i)
            for a in arms:
                g.add_contig(a)
            g.add_contig(tail)
            fixed += 1
            progressed = True
        if not progressed:
            break
    return fixed


EQLEN_RATIO = 0.8  # pop threshold for equal-length parallel arms


def seq_rank64(s: str) -> int:
    """Deterministic 64-bit order key of a sequence (FNV-1a bytes).

    pop_bubbles breaks exact-coverage ties on this key instead of the
    full canonical sequence so the partitioned cleaner (dist/halo.py)
    can replicate the ordering with one fixed-width message field; a
    collision (~2^-64 per pair) would only flip which of two
    equal-coverage arms survives."""
    h = 0xcbf29ce484222325
    for ch in s.encode():
        h ^= ch
        h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


def pop_bubbles(g: ContigGraph, ratio: float = 0.25) -> int:
    """Delete low-coverage parallel arms: when >=2 contigs connect the
    SAME pair of junction nodes, arms at <= ratio x the strongest arm's
    coverage are sequencing-error paths (a doubled error creates a
    ~read-length bubble whose arm coverage tracks the error multiplicity
    — often ABOVE the absolute min_cov floor at high depth, which is
    exactly why an absolute threshold cannot remove it). SURVEY.md §A.7b
    sanctions a relative chimera threshold; real parallel repeats keep
    comparable coverage on both arms and are preserved.

    EQUAL-LENGTH arms get a looser threshold (EQLEN_RATIO): when a
    bubble's rejoin junction goes unrecorded (a B false positive at the
    error k-mer's promotion shadows new_b — core/nodes.py docstring),
    the two arms run parallel all the way to the NEXT junction with a
    duplicated tail, and the weak arm's end-averaged coverage is
    inflated by the shared tail's depth; identical arm length between
    one node pair is the signature of that single-variant artifact.

    Ports clashed by such duplicated tails (two arms entering the same
    (node, slot); registration is last-writer-wins) are re-registered
    for the surviving arms so collapse can proceed.

    Snapshot semantics (round 4): ALL groups classify from the
    round-start state, then every kill applies, then survivors of
    popped groups re-register — so the partitioned halo cleaner's
    batched exchanges produce the identical registry by construction
    (no cross-group insertion-order dependence)."""
    arms = {}
    for i in g.live():
        c = g.contigs[i]
        if c.circular or c.left is None or c.right is None:
            continue
        key = tuple(sorted((c.left.node, c.right.node)))
        arms.setdefault(key, []).append(i)
    kills, resurvey = [], []
    for idxs in arms.values():
        if len(idxs) < 2:
            continue
        cs = [g.contigs[i] for i in idxs]
        top_i = max(range(len(idxs)),
                    key=lambda j: (cs[j].cov,
                                   seq_rank64(cs[j].canonical_seq())))
        top = cs[top_i].cov
        top_len = len(cs[top_i].seq)
        g_kill = [i for j, i in enumerate(idxs)
                  if j != top_i and (
                      cs[j].cov <= ratio * top
                      or (len(cs[j].seq) == top_len
                          and cs[j].cov <= EQLEN_RATIO * top))]
        if g_kill:
            kills.extend(g_kill)
            resurvey.extend(i for i in idxs if i not in g_kill)
    for i in kills:
        g.remove_contig(i)
    for i in resurvey:
        c = g.contigs[i]
        for e, end in ((c.left, "L"), (c.right, "R")):
            g.ports.setdefault(e.node, {}).setdefault(e.slot, (i, end))
    return len(kills)


def collapse_all(g: ContigGraph) -> int:
    merged = 0
    for node in list(g.ports.keys()):
        if node in g.ports and g.collapse_node(node):
            merged += 1
    return merged


def disentangle(g: ContigGraph, pair_count, min_pairs: int = 2,
                cross_max: int = 0) -> int:
    """Split 2-in/2-out repeat nodes whose paired-end evidence supports a
    unique in->out matching (SURVEY.md §A.7e, §3.4; reference analogue
    ContigGraph::disentangle, ref:src/ContigGraph.cpp [C:med]).

    pair_count: callable (nodeA_kmer_str, nodeB_kmer_str) -> observed
    mate-pair co-occurrence count. Evidence nodes are the far-end
    junctions of the four incident contigs.
    """
    resolved = 0
    for node in list(g.ports):
        d = g.ports.get(node)
        if not d or len(d) != 4:
            continue
        rs = sorted(s for s in d if s < 4)
        ls = sorted(s for s in d if s >= 4)
        if len(rs) != 2 or len(ls) != 2:
            continue
        if len({d[s][0] for s in rs + ls}) != 4:
            continue  # loops / palindromic attachments: leave alone

        def far(s):
            idx, e = d[s]
            c = g.contigs[idx]
            other = c.right if e == "L" else c.left
            return None if other is None else other.node

        def pc(a, b):
            if a is None or b is None or a == node or b == node:
                return 0
            return pair_count(a, b)

        f = {s: far(s) for s in rs + ls}
        c11 = pc(f[ls[0]], f[rs[0]])
        c12 = pc(f[ls[0]], f[rs[1]])
        c21 = pc(f[ls[1]], f[rs[0]])
        c22 = pc(f[ls[1]], f[rs[1]])
        if (c11 >= min_pairs and c22 >= min_pairs
                and c12 <= cross_max and c21 <= cross_max):
            g.merge_through(node, rs[0], ls[0])
            g.merge_through(node, rs[1], ls[1])
            resolved += 1
        elif (c12 >= min_pairs and c21 >= min_pairs
                and c11 <= cross_max and c22 <= cross_max):
            g.merge_through(node, rs[1], ls[0])
            g.merge_through(node, rs[0], ls[1])
            resolved += 1
    resolved += _disentangle_chains(g, pair_count, min_pairs, cross_max)
    return resolved


def _disentangle_chains(g: ContigGraph, pair_count, min_pairs: int,
                        cross_max: int) -> int:
    """Duplicate a repeat contig R between junctions x (2 in) and y (2
    out) when pair evidence uniquely matches the inbound and outbound
    flanks: A-R-B / C-R-D replace {A, C, R, B, D}.

    Face invariant used for splicing (graph/model.py docstring): two
    contigs on opposite faces of a node, oriented toward each other,
    always present the node k-mer in the same orientation — so glued
    sequences line up without canonicalization.
    """
    from faucet_tpu_torch.core.kmer import revcomp_seq
    from faucet_tpu_torch.graph.model import Contig

    k = g.k
    resolved = 0
    for ridx in list(g.live()):
        R = g.contigs[ridx]
        if R.deleted or R.circular or R.left is None or R.right is None:
            continue
        x, y = R.left.node, R.right.node
        if x == y:
            continue
        dx, dy = g.ports.get(x, {}), g.ports.get(y, {})
        if len(dx) != 3 or len(dy) != 3:
            continue
        # x: R on one face alone, two flank ports on the other face
        x_face = R.left.slot < 4
        xf = [s for s in dx if (s < 4) == x_face]
        xo = sorted(s for s in dx if (s < 4) != x_face)
        y_face = R.right.slot < 4
        yf = [s for s in dy if (s < 4) == y_face]
        yo = sorted(s for s in dy if (s < 4) != y_face)
        if len(xf) != 1 or len(xo) != 2 or len(yf) != 1 or len(yo) != 2:
            continue
        pa, pc_ = dx[xo[0]], dx[xo[1]]   # flank ports at x (A, C)
        pb, pd = dy[yo[0]], dy[yo[1]]    # flank ports at y (B, D)
        idxs = {ridx, pa[0], pc_[0], pb[0], pd[0]}
        if len(idxs) != 5:
            continue

        def far_of(port):
            i, e = port
            c = g.contigs[i]
            other = c.left if e == "R" else c.right
            return None if other is None else other.node

        def pcnt(a, b):
            if a is None or b is None or a in (x, y) or b in (x, y):
                return 0
            return pair_count(a, b)

        fa, fc = far_of(pa), far_of(pc_)
        fb, fd = far_of(pb), far_of(pd)
        ab, ad = pcnt(fa, fb), pcnt(fa, fd)
        cb, cd = pcnt(fc, fb), pcnt(fc, fd)
        if ab >= min_pairs and cd >= min_pairs and ad <= cross_max \
                and cb <= cross_max:
            matching = [(pa, pb), (pc_, pd)]
        elif ad >= min_pairs and cb >= min_pairs and ab <= cross_max \
                and cd <= cross_max:
            matching = [(pa, pd), (pc_, pb)]
        else:
            continue

        def orient_in(port):   # flank at x, oriented with x at its right
            i, e = port
            c = g.contigs[i]
            seq = c.seq if e == "R" else revcomp_seq(c.seq)
            farend = c.left if e == "R" else c.right
            return seq, farend

        def orient_out(port):  # flank at y, oriented with y at its left
            i, e = port
            c = g.contigs[i]
            seq = c.seq if e == "L" else revcomp_seq(c.seq)
            farend = c.right if e == "L" else c.left
            return seq, farend

        # orient R with x at its left end
        r_e = dx[xf[0]][1]
        r_seq = R.seq if r_e == "L" else revcomp_seq(R.seq)

        new_contigs = []
        ok = True
        for pin, pout in matching:
            a_seq, a_far = orient_in(pin)
            b_seq, b_far = orient_out(pout)
            if a_seq[-k:] != r_seq[:k] or r_seq[-k:] != b_seq[:k]:
                ok = False
                break
            seq = a_seq + r_seq[k:] + b_seq[k:]
            ca = g.contigs[pin[0]]
            cb2 = g.contigs[pout[0]]
            n_a = len(ca.seq) - k + 1
            n_b = len(cb2.seq) - k + 1
            n_r = len(R.seq) - k + 1
            cov = (ca.cov * n_a + cb2.cov * n_b + R.cov * n_r) / (
                n_a + n_b + n_r)
            new_contigs.append(Contig(seq=seq, cov=cov, left=a_far,
                                      right=b_far))
        if not ok:
            continue
        for i in (ridx, pa[0], pc_[0], pb[0], pd[0]):
            g.remove_contig(i)
        for c in new_contigs:
            g.add_contig(c)
        resolved += 1
    return resolved


def clean(g: ContigGraph, max_tip_len: int = 200, min_cov: float = 2.0,
          do_tips: bool = True, do_low_cov: bool = True,
          pair_count=None, min_pairs: int = 2,
          max_rounds: int = 64, bubble_ratio: float = 0.25) -> dict:
    """Iterate passes to fixpoint; then disentangle once with paired-end
    evidence (if provided) and re-clean. Returns pass counters."""
    stats = {"tips": 0, "low_cov": 0, "chimeric": 0, "isolated": 0,
             "bubbles": 0, "collapsed": 0, "repaired": 0,
             "disentangled": 0, "rounds": 0}

    def fixpoint():
        for _ in range(max_rounds):
            nt, nl, nch, ni = _delete_round(g, max_tip_len, min_cov,
                                            do_tips, do_low_cov,
                                            chim_ratio=bubble_ratio)
            stats["tips"] += nt
            stats["low_cov"] += nl
            stats["chimeric"] += nch
            stats["isolated"] += ni
            nb = pop_bubbles(g, bubble_ratio) if (
                do_low_cov and bubble_ratio > 0) else 0
            stats["bubbles"] += nb
            # kills can orphan clash-hidden survivor ports; repair
            # before collapse so 1-1 nodes with a repaired port merge
            nr = repair_ports(g)
            stats["repaired"] += nr
            nc = collapse_all(g)
            stats["collapsed"] += nc
            stats["rounds"] += 1
            if not (nt + nl + nch + ni + nb + nc + nr):
                break

    fixpoint()
    if pair_count is not None:
        n = disentangle(g, pair_count, min_pairs=min_pairs)
        stats["disentangled"] = n
        if n:
            fixpoint()
    return stats
