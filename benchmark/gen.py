"""Synthetic genomes and read sets, vectorised, from a seed.

Rewritten from faucet_tpu_torch/simulate.py (`genome_with_repeats`,
`shred`) with the same semantics: a random genome with one repeat unit
planted n_repeats times between equal random chunks, reads of one length
at uniform start positions on the circular genome, each base replaced by
a uniformly drawn base (possibly itself) with probability err_rate, and
each read reverse-complemented with probability 1/2. The original draws
per read in a Python loop; here every draw is one torch call on the
device, from a torch.Generator.

Bases are codes A=0, C=1, G=2, T=3; 4 pads a read past its length.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Reads(NamedTuple):
    bases: torch.Tensor  # uint8[n_rows, read_len]
    lens: torch.Tensor   # int32[n_rows]; 0 for the padding rows
    n_reads: int         # real reads (rows past them are padding)
    starts: torch.Tensor   # int64[n_reads] genome position of each read
    flipped: torch.Tensor  # bool[n_reads] reverse-complemented


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def genome_with_repeats(g: torch.Generator, length: int, n_repeats: int,
                        repeat_len: int) -> torch.Tensor:
    """uint8[length]: random bases with one random unit of repeat_len
    planted n_repeats times, each after a random chunk of
    (length - n_repeats * repeat_len) // (n_repeats + 1) bases."""
    dev = g.device
    genome = torch.randint(0, 4, (length,), generator=g, device=dev,
                           dtype=torch.uint8)
    unit = torch.randint(0, 4, (repeat_len,), generator=g, device=dev,
                         dtype=torch.uint8)
    chunk = (length - n_repeats * repeat_len) // (n_repeats + 1)
    for i in range(n_repeats):
        at = i * (chunk + repeat_len) + chunk
        genome[at:at + repeat_len] = unit
    return genome


def shred(g: torch.Generator, genome: torch.Tensor, coverage: float,
          read_len: int, err_rate: float, batch_reads: int) -> Reads:
    """Reads of the circular genome at `coverage`, padded with empty rows
    to whole batches of batch_reads (the rows the port's batch_iter adds
    to a last, partial batch)."""
    dev = genome.device
    G = genome.shape[0]
    n = max(1, int(coverage * G / read_len))
    starts = torch.randint(0, G, (n,), generator=g, device=dev)
    idx = (starts[:, None] + torch.arange(read_len, device=dev)) % G
    reads = genome[idx]
    hit = torch.rand((n, read_len), generator=g, device=dev) < err_rate
    sub = torch.randint(0, 4, (n, read_len), generator=g, device=dev,
                        dtype=torch.uint8)
    reads = torch.where(hit, sub, reads)
    flip = torch.rand((n,), generator=g, device=dev) < 0.5
    reads = torch.where(flip[:, None], 3 - reads.flip(1), reads)
    rows = -(-n // batch_reads) * batch_reads
    bases = torch.full((rows, read_len), 4, dtype=torch.uint8, device=dev)
    bases[:n] = reads
    lens = torch.zeros((rows,), dtype=torch.int32, device=dev)
    lens[:n] = read_len
    return Reads(bases, lens, n, starts, flip)


def n_repeats(cfg: dict) -> int:
    return max(cfg["min_repeats"], cfg["genome_len"] // cfg["bp_per_repeat"])


def chunk_len(cfg: dict) -> int:
    """Bases between two repeat copies: the genome's repeat-free
    stretches are n_repeats - 1 of this length and one of about twice it
    (the last chunk and the first meet across the circle), so this is the
    N50 of an assembly that breaks only at the repeat."""
    n = n_repeats(cfg)
    return (cfg["genome_len"] - n * cfg["repeat_len"]) // (n + 1)


def make(cfg: dict, seed: int, device):
    """(genome, reads) of a configuration (benchmark/configs/*.json).

    The genome and the read set come from the configuration's data_seed,
    and `seed` draws the order of the reads within each batch. Every run
    then does the same work: the cascade's filters and the tables' content
    do not depend on the order inside a batch, so neither do the graph
    and its lockstep walk, whose length is that of the longest walk (a
    batch composition drawn anew moves a Bloom false positive, and with
    it the longest walk by up to a fifth; a genome drawn anew, its
    assembly by up to two fifths). benchmark/calibrate.py draws the
    genome from each seed instead, for the readings of the limits."""
    g = generator(cfg["data_seed"], device)
    G = cfg["genome_len"]
    genome = genome_with_repeats(g, G, n_repeats(cfg), cfg["repeat_len"])
    reads = shred(g, genome, cfg["coverage"], cfg["read_len"],
                  cfg["err_rate"], cfg["batch_reads"])
    n = reads.n_reads
    dev = genome.device
    batch = torch.arange(n, device=dev) // cfg["batch_reads"]
    order = torch.argsort(batch + torch.rand(
        (n,), generator=generator(seed, device), device=dev,
        dtype=torch.float64))
    reads.bases[:n] = reads.bases[:n][order]
    return genome, reads._replace(starts=reads.starts[order],
                                  flipped=reads.flipped[order])
