# Host code copied verbatim from faucet_tpu/simulate.py; only the imports point
# at faucet_tpu_torch, whose modules import no jax.
"""Synthetic genome / read-set generators for tests and benchmarks.

The reference validated on real datasets only (SURVEY.md §4); with no
network in this environment (SURVEY.md §0), benchmark configs are emulated
by synthetic genomes with planted repeats and error-bearing shredded reads
whose ground truth is known exactly.
"""
from __future__ import annotations

import numpy as np

from faucet_tpu_torch.core.kmer import revcomp_seq

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng: np.random.Generator, length: int) -> str:
    return _BASES[rng.integers(0, 4, size=length)].tobytes().decode()


def genome_with_repeats(rng: np.random.Generator, length: int,
                        n_repeats: int = 2, repeat_len: int = 300) -> str:
    """Random genome with a repeat unit planted n_repeats times — creates
    true junctions at repeat boundaries (the structure Faucet's junction
    machinery exists for)."""
    unit = random_genome(rng, repeat_len)
    chunk = (length - n_repeats * repeat_len) // (n_repeats + 1)
    parts = []
    for i in range(n_repeats):
        parts.append(random_genome(rng, chunk))
        parts.append(unit)
    parts.append(random_genome(rng, max(length - sum(map(len, parts)), 1)))
    return "".join(parts)


def shred(rng: np.random.Generator, genome: str, coverage: float,
          read_len: int = 100, err_rate: float = 0.0,
          circular: bool = False, both_strands: bool = True,
          paired: bool = False, insert: int = 300):
    """Uniform shotgun reads. Returns list[str], or (mates1, mates2) when
    paired. Errors are uniform substitutions (the dominant Illumina mode).
    """
    G = len(genome)
    n_reads = max(1, int(coverage * G / read_len))
    src = genome + genome[: read_len + (insert if paired else 0)] \
        if circular else genome
    max_start = (G if circular
                 else G - (insert if paired else read_len))
    if max_start <= 0:
        raise ValueError("genome shorter than read/insert length")
    starts = rng.integers(0, max_start, size=n_reads)

    def one(p):
        r = src[p : p + read_len]
        if err_rate > 0:
            arr = np.frombuffer(r.encode(), np.uint8).copy()
            hit = rng.random(len(arr)) < err_rate
            arr[hit] = _BASES[rng.integers(0, 4, size=int(hit.sum()))]
            r = arr.tobytes().decode()
        return r

    if not paired:
        reads = []
        for p in starts:
            r = one(int(p))
            if both_strands and rng.random() < 0.5:
                r = revcomp_seq(r)
            reads.append(r)
        return reads

    m1, m2 = [], []
    for p in starts:
        a = one(int(p))
        b = revcomp_seq(one(int(p) + insert - read_len))
        if both_strands and rng.random() < 0.5:
            a, b = revcomp_seq(b), revcomp_seq(a)
        m1.append(a)
        m2.append(b)
    return m1, m2


def write_fasta(path: str, seqs, prefix: str = "read"):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{prefix}{i}\n{s}\n")


def write_fastq(path: str, seqs, prefix: str = "read"):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@{prefix}{i}\n{s}\n+\n{'I' * len(s)}\n")
