"""Owner-routed frontier walks (dist/swalk.py) on 4 gloo ranks: routed and
unrouted walks give the same contigs, the routed bytes are counted only
when routed, and they equal the reference's walk_route_bytes on the same
case (tests/dist/test_swalk.py:41); the contigs equal the reference's
routed sharded build.
"""
import pytest
import torch

import torch_dist_ranks as DR
from faucet_tpu_torch.dist.mesh import spawn
from torch_dist_ref import S, run_ref

torch.set_num_threads(1)

# a small wave program, as the reference's test
WALK = dict(fp_rate=0.002, walk_round_steps=32, walk_rounds_per_call=2)
CASES = tuple(
    (name, dict(inp="repeats99", cfg_kw={**WALK, "route_walks": routed},
                clean=False))
    for name, routed in (("routed", True), ("unrouted", False)))


@pytest.fixture(scope="module")
def results():
    join = DR.in_background(spawn, DR.run_cases, S, args=(CASES,),
                            threads=1, timeout=400)
    ref = run_ref(**dict(CASES)["routed"])
    return join(), ref


def test_routed_walks_bit_identical_and_counted(results):
    ranks, ref = results
    routed, unrouted = ranks[0]["routed"], ranks[0]["unrouted"]
    assert routed["raw"] == unrouted["raw"] == ref["raw"]
    assert len(routed["raw"]) > 0
    got = routed["metrics"]["walk_route_bytes"]
    assert got == ref["metrics"]["walk_route_bytes"] > 0
    assert unrouted["metrics"]["walk_route_bytes"] == 0
    for r in ranks[1:]:
        assert r["routed"]["raw"] == routed["raw"]
