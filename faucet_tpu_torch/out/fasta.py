# Host code copied verbatim from faucet_tpu/out/fasta.py; only the imports point
# at faucet_tpu_torch, whose modules import no jax.
"""Contig FASTA emission (reference analogue: printContigs,
ref:src/ContigGraph.cpp [C:med]; header fields per SURVEY.md §A.8)."""
from __future__ import annotations

from faucet_tpu_torch.graph.model import ContigGraph


def write_contigs(g: ContigGraph, path: str, line_width: int = 80):
    with open(path, "w") as f:
        for n, i in enumerate(g.live()):
            c = g.contigs[i]
            circ = " circular=true" if c.circular else ""
            f.write(f">contig_{n} length={len(c.seq)} cov={c.cov:.2f}{circ}\n")
            for j in range(0, len(c.seq), line_width):
                f.write(c.seq[j : j + line_width] + "\n")


def read_fasta(path: str):
    """Minimal FASTA reader (also used to load test genomes)."""
    name, seq = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(seq)
                name, seq = line[1:], []
            else:
                seq.append(line)
    if name is not None:
        yield name, "".join(seq)
