"""Sharded pipeline pieces (port of faucet_tpu/dist/sharded.py).

For now this module holds only `prune_slots`, which the single-device
`Pipeline.build` calls when `prune_slot_cov > 0`. The rest of the
reference's module (ShardedPipeline, state placement, the per-shard
Config views) comes with the port of dist/ (ROADMAP.md A15).
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import table as T


def prune_slots(junctions: T.Table, min_slot_cov: int) -> T.Table:
    """Device pre-clean: zero the junction slots (cov8 entries) whose
    coverage is below the floor before walking; the other value columns
    are left as they are. Elementwise, so a sharded table prunes each
    shard locally. Every pruned slot is a contig the host's low-coverage
    pass would have removed, but it is never walked."""
    cov8 = junctions.vals[0]
    keep = cov8 >= min_slot_cov
    return junctions._replace(
        vals=(torch.where(keep, cov8, 0),) + tuple(junctions.vals[1:]))
