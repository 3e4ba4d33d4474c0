# Copied verbatim from faucet_tpu/io/fastq.py: the port imports nothing of
# faucet_tpu.
"""FASTA/FASTQ streaming readers.

Reference analogue: the driver's getline-loop reader (SURVEY.md §2.1
"Read I/O" [C:med]) — works on regular files and FIFOs/pipes (the
streaming mode the tool is named for). gzip is handled transparently by
suffix (the reference README pipes zcat into a FIFO instead [C:low]).

This Python reader is the portable fallback; the C++ packer extension
(io/cpp) is the hot path that also 2-bit-packs on the fly.
"""
from __future__ import annotations

import gzip
import sys
from typing import Iterator, TextIO


def _open(path: str) -> TextIO:
    if path == "-":
        return sys.stdin
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta_seqs(path: str) -> Iterator[str]:
    cur = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    yield "".join(cur)
                    cur = []
            else:
                cur.append(line)
        if cur:
            yield "".join(cur)


def read_fastq_seqs(path: str) -> Iterator[str]:
    with _open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().strip()
            f.readline()  # '+'
            f.readline()  # quals
            if header.startswith("@"):
                yield seq


def read_seqs(path: str, fastq: bool = False) -> Iterator[str]:
    return read_fastq_seqs(path) if fastq else read_fasta_seqs(path)


def deinterleave(seqs: Iterator[str]):
    """Interleaved paired stream -> (mate1, mate2) tuples."""
    it = iter(seqs)
    while True:
        try:
            a = next(it)
        except StopIteration:
            return
        try:
            b = next(it)
        except StopIteration:
            return
        yield a, b
