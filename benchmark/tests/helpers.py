"""Tiny cells for the benchmark's CPU tests."""
from __future__ import annotations

import torch

from benchmark import run

torch.set_num_threads(2)


def tiny(cell: str, genome_len: int = 12_000, coverage: float = 20.0,
         batch_reads: int = 512, root: str = run.HERE) -> dict:
    """The cell's spec at a size a CPU test holds."""
    spec = run.load_spec(cell, root)
    spec["config"].update(genome_len=genome_len, coverage=coverage,
                          batch_reads=batch_reads)
    return spec
