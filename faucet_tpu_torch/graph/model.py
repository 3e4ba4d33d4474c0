# Host code copied verbatim from faucet_tpu/graph/model.py; only the imports point
# at faucet_tpu_torch, whose modules import no jax.
"""Host-side compacted-graph model: contigs + junction-node ports.

Reference analogue: ref:src/Contig.{h,cpp}, ref:src/ContigNode.{h,cpp},
ref:src/ContigGraph.{h,cpp} (SURVEY.md §2.1, [C:high]). After the device
phases (stream/scan/walk) the compacted graph is tiny — O(branch points of
the genome) — so it is extracted to the host; cleaning operates here. Both
the NumPy golden refimpl and the TPU pipeline build this same model, which
is what makes them differentially comparable end-to-end (SURVEY.md §7.1.6).

Orientation invariants for a port (contig, end, slot) on node x with
canonical k-mer string X (see core/slots.py for slot semantics):

  (end='L', slot<4)  <=> contig.seq[:k]  == X        (walk exits x right)
  (end='L', slot>=4) <=> contig.seq[:k]  == rc(X)    (walk exits x left)
  (end='R', slot>=4) <=> contig.seq[-k:] == X        (walk entered from left)
  (end='R', slot<4)  <=> contig.seq[-k:] == rc(X)    (walk entered from right)

Adjacent contigs through a node share the full k bases of its k-mer, so
GFA links carry a k-base overlap (an intentional, documented divergence
from (k-1)-overlap unitig conventions: our nodes are k-mers, and every
incident contig includes the node k-mer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from faucet_tpu_torch.core.kmer import revcomp_seq


@dataclasses.dataclass
class End:
    node: str   # canonical k-mer string of the junction node
    slot: int   # slot of that node occupied by this contig


@dataclasses.dataclass
class Contig:
    seq: str
    cov: float = 0.0
    left: Optional[End] = None    # node whose k-mer is seq[:k]
    right: Optional[End] = None   # node whose k-mer is seq[-k:]
    circular: bool = False        # seq is one full cycle, no wrap duplication
    deleted: bool = False

    def __len__(self):
        return len(self.seq)

    def canonical_seq(self) -> str:
        if self.circular:
            # normalize rotation+orientation: smallest rotation of the
            # smaller of seq / rc(seq)
            def min_rot(s):
                return min(s[i:] + s[:i] for i in range(len(s)))
            return min(min_rot(self.seq), min_rot(revcomp_seq(self.seq)))
        return min(self.seq, revcomp_seq(self.seq))

    def flipped(self) -> "Contig":
        return dataclasses.replace(
            self, seq=revcomp_seq(self.seq), left=self.right, right=self.left)


class ContigGraph:
    """Contigs + per-node port index. Nodes are canonical k-mer strings."""

    def __init__(self, k: int, contigs: Optional[List[Contig]] = None):
        self.k = k
        self.contigs: List[Contig] = []
        # node -> slot -> (contig_idx, 'L'|'R')
        self.ports: Dict[str, Dict[int, Tuple[int, str]]] = {}
        for c in contigs or []:
            self.add_contig(c)

    # ---- construction ---------------------------------------------------
    def add_contig(self, c: Contig) -> int:
        idx = len(self.contigs)
        self.contigs.append(c)
        if not c.deleted:
            self._index_ports(idx)
        return idx

    def _index_ports(self, idx: int):
        c = self.contigs[idx]
        if c.left is not None:
            self.ports.setdefault(c.left.node, {})[c.left.slot] = (idx, "L")
        if c.right is not None:
            self.ports.setdefault(c.right.node, {})[c.right.slot] = (idx, "R")

    def _drop_ports(self, idx: int):
        c = self.contigs[idx]
        for e in (c.left, c.right):
            if e is None:
                continue
            d = self.ports.get(e.node)
            if d and d.get(e.slot, (None,))[0] == idx:
                del d[e.slot]
                if not d:
                    del self.ports[e.node]

    # ---- mutation (cleaning primitives) --------------------------------
    def remove_contig(self, idx: int):
        self._drop_ports(idx)
        self.contigs[idx].deleted = True

    def live(self) -> List[int]:
        return [i for i, c in enumerate(self.contigs) if not c.deleted]

    def node_degree(self, node: str) -> Tuple[int, int]:
        """(right-side ports, left-side ports) currently attached."""
        d = self.ports.get(node, {})
        r = sum(1 for s in d if s < 4)
        l = sum(1 for s in d if s >= 4)
        return r, l

    def collapse_node(self, node: str) -> bool:
        """Merge the two contigs through a 1-in/1-out node. Returns True if
        a merge happened. Reference analogue: collapseDummyNodes
        (ref:src/ContigGraph.cpp [C:med])."""
        d = self.ports.get(node)
        if not d or len(d) != 2:
            return False
        slots = sorted(d)
        if not (slots[0] < 4 <= slots[1]):
            return False  # both ports on the same side: real branch remains
        return self.merge_through(node, slots[0], slots[1])

    def merge_through(self, node: str, rslot: int, lslot: int) -> bool:
        """Merge the contig on right-slot `rslot` with the contig on
        left-slot `lslot` through `node` (also the disentangle splice
        primitive, SURVEY.md §A.7e)."""
        d = self.ports.get(node)
        if not d or rslot not in d or lslot not in d:
            return False
        assert rslot < 4 <= lslot
        (i1, e1) = d[rslot]   # right-slot port
        (i2, e2) = d[lslot]   # left-slot port
        k = self.k
        X = node
        c1, c2 = self.contigs[i1], self.contigs[i2]

        if i1 == i2:
            # both ends of the same contig meet at this node: a cycle
            right_part = c1.seq if e1 == "L" else revcomp_seq(c1.seq)
            assert right_part[:k] == X and right_part[-k:] == X
            self._drop_ports(i1)
            c1.seq = right_part[:-k]
            c1.circular = True
            c1.left = c1.right = None
            return True

        # orient: left part ends with X, right part starts with X
        right_seq = c1.seq if e1 == "L" else revcomp_seq(c1.seq)
        right_far = c1.right if e1 == "L" else c1.left
        left_seq = c2.seq if e2 == "R" else revcomp_seq(c2.seq)
        left_far = c2.left if e2 == "R" else c2.right
        assert right_seq[:k] == X, "port orientation invariant broken"
        assert left_seq[-k:] == X, "port orientation invariant broken"

        n1 = len(c1.seq) - k + 1
        n2 = len(c2.seq) - k + 1
        cov = (c1.cov * n1 + c2.cov * n2) / max(n1 + n2, 1)
        merged = Contig(seq=left_seq + right_seq[k:], cov=cov,
                        left=left_far, right=right_far)
        self.remove_contig(i1)
        self.remove_contig(i2)
        self.add_contig(merged)
        return True

    # ---- queries --------------------------------------------------------
    def links(self) -> List[Tuple[int, str, int, str]]:
        """GFA-style links: (contig_a, sign_a, contig_b, sign_b) for every
        left-port/right-port pair through every node; a(sign_a) ends where
        b(sign_b) begins, overlapping k bases."""
        out = []
        for node, d in self.ports.items():
            rights = [(s, d[s]) for s in sorted(d) if s < 4]
            lefts = [(s, d[s]) for s in sorted(d) if s >= 4]
            for _, (ib, eb) in rights:   # contig leaving node rightward
                for _, (ia, ea) in lefts:  # contig entering node from left
                    sign_a = "+" if ea == "R" else "-"
                    sign_b = "+" if eb == "L" else "-"
                    out.append((ia, sign_a, ib, sign_b))
        return out

    def stats(self) -> Dict[str, float]:
        lens = sorted((len(self.contigs[i]) for i in self.live()),
                      reverse=True)
        total = sum(lens)
        n50 = 0
        acc = 0
        for L in lens:
            acc += L
            if acc * 2 >= total:
                n50 = L
                break
        return {
            "contigs": len(lens),
            "total_bases": total,
            "max_len": lens[0] if lens else 0,
            "n50": n50,
            "nodes": len(self.ports),
        }
