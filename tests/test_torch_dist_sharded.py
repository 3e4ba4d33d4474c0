"""The port's sharded pipeline (one process per shard, 4 gloo ranks on the
CPU) against the reference's ShardedPipeline on a 4-device CPU mesh and
against the port's own single-device Pipeline.

The global arrays (the ranks' slices in rank order) must equal the
reference's bit for bit, slot arrays included, and the single-device
pipeline's, as tests/dist/test_sharded.py asserts for the reference; the
raw and cleaned contigs must be equal too. Cases: Bloom and exact mode at
k = 21 (branch-node junctions), prune_slot_cov = 2, and starved routing
buffers that force several all_to_all rounds per route
(tests/dist/test_lossless.py:123; there the single-device comparison is
of table content, as in the reference's test, since the round structure
differs). The ranks start once per module and run every case.
"""
import pytest
import torch

from torch_dist_ref import assert_state_equal, run_all

torch.set_num_threads(1)

TINY = dict(exact=True, estimated_kmers=1 << 13, singletons=1 << 13,
            junction_capacity=1 << 12, sink_capacity=1 << 13,
            scan_update_cap=128)
CASES = (
    ("bloom", dict(inp="repeats2024", cfg_kw={})),
    ("exact", dict(inp="repeats2024", cfg_kw={"exact": True})),
    ("prune", dict(inp="repeats2024", cfg_kw={"prune_slot_cov": 2})),
    ("tiny", dict(inp="tiny7", cfg_kw=TINY, cap_factor=4)),
)


@pytest.fixture(scope="module")
def results():
    return run_all(CASES)


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_sharded_arrays_and_contigs(results, name):
    ranks, ref, single = results
    got = ranks[0][name]
    exact_slots = name != "tiny"
    assert_state_equal(got, ref[name])
    assert_state_equal(got, single[name], slots=exact_slots)
    assert got["metrics"]["route_dropped"] == 0
    assert got["raw"] == ref[name]["raw"] == single[name]["raw"]
    assert got["clean"] == ref[name]["clean"] == single[name]["clean"]
    assert len(got["raw"]) > 0
    # every rank built the same graph
    for r in ranks[1:]:
        assert r[name]["raw"] == got["raw"]
        assert r[name]["clean"] == got["clean"]
    # starved buffers: some routes took extra carry rounds; else none
    assert (got["collectives"]["carry_rounds"] > 0) == (name == "tiny")
    if name == "prune":
        # no slot under the floor survives the pre-clean
        cov = got["junctions"]["vals"][0]
        assert ((cov == 0) | (cov >= 2)).all()
