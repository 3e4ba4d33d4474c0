# Host code copied verbatim from faucet_tpu/out/gfa.py; only the imports point
# at faucet_tpu_torch, whose modules import no jax.
"""GFA 1.0 emission of the assembly graph.

Reference analogue: printGFA (ref:src/ContigGraph.cpp [C:med]; SURVEY.md
§A.8: "links = node adjacencies, overlap = k-1"). Segments are contigs;
links connect contigs adjacent through a junction node.

Overlap convention (VERDICT r1 #7): the in-memory model stores the FULL
junction k-mer at every incident contig end, so raw adjacent contigs
overlap k bases. For standard unitig-convention GFA (what Bandage /
gfatools expect) emission trims ONE base from every contig end attached
at a LEFT-side port (slot >= 4): the entering side then carries the
shared (k-1)-mer and every L-line overlap is exactly k-1, so walking
S/L lines with (k-1)-base joins reconstructs the underlying sequence.
`overlap="k"` emits the legacy untrimmed form.
"""
from __future__ import annotations

from faucet_tpu_torch.graph.model import ContigGraph


def _trims(g: ContigGraph, idx: int):
    """(head_trim, tail_trim) in the contig's own string frame: 1 where
    the end is attached at a left-side (slot >= 4) port."""
    c = g.contigs[idx]
    head = tail = 0
    for e in (c.left, c.right):
        if e is None or e.slot < 4:
            continue
        d = g.ports.get(e.node, {})
        port = d.get(e.slot)
        if port is None or port[0] != idx:
            continue
        # only trim when some right-side contig still carries the full
        # node k-mer (else the base would vanish from the assembly)
        if not any(s < 4 for s in d):
            continue
        if port[1] == "L":
            head = 1
        else:
            tail = 1
    return head, tail


def write_gfa(g: ContigGraph, path: str, overlap: str = "k-1"):
    assert overlap in ("k-1", "k")
    live = g.live()
    name = {idx: f"contig_{n}" for n, idx in enumerate(live)}
    k_ov = g.k - 1 if overlap == "k-1" else g.k
    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for idx in live:
            c = g.contigs[idx]
            seq = c.seq
            if overlap == "k-1":
                head, tail = _trims(g, idx)
                seq = seq[head: len(seq) - tail or None]
            f.write(f"S\t{name[idx]}\t{seq}\tdp:f:{c.cov:.2f}\n")
        seen = set()
        for ia, sa, ib, sb in g.links():
            rec = (ia, sa, ib, sb)
            # a link and its reverse-complement reading are the same edge
            rev = (ib, "+" if sb == "-" else "-", ia, "+" if sa == "-" else "-")
            if rec in seen or rev in seen:
                continue
            seen.add(rec)
            f.write(f"L\t{name[ia]}\t{sa}\t{name[ib]}\t{sb}\t{k_ov}M\n")
