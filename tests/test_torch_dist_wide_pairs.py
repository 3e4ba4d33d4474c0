"""The port's sharded pipeline at k = 55 and with paired ends (4 gloo ranks
on the CPU) against the reference's ShardedPipeline on a 4-device CPU mesh
and the port's single-device Pipeline.

k = 55: wide codes with ext8 junctions; the wide tables carry the code
words, and the walks run unrouted on the gathered global arrays (routed
walks are for narrow codes, as in the reference). Paired: the phased
repeat of tests/dist/test_pairs_sharded.py:48 (exact mode), whose pair
table, pair counts and phasing must match; the sharded disentangle must
splice the two true paths and no wrong one. Global arrays bit for bit,
raw and cleaned contigs equal.
"""
import pytest
import torch

import torch_dist_ranks as DR
from torch_dist_ref import assert_state_equal, run_all

torch.set_num_threads(1)

PAIRED = dict(max_read_length=80, batch_reads=128, exact=True,
              estimated_kmers=1 << 15, singletons=1 << 15,
              junction_capacity=1 << 13, sink_capacity=1 << 15,
              pair_capacity=1 << 14, paired_ends=True)
CASES = (
    ("k55", dict(inp="repeats2024", cfg_kw={"size_kmer": 55})),
    ("paired", dict(inp="phased", cfg_kw=PAIRED, paired=True)),
)


@pytest.fixture(scope="module")
def results():
    return run_all(CASES)


def _phasing(keys, truths, wrongs):
    from faucet_tpu_torch.core.kmer import revcomp_seq

    joined = "#".join(keys + [revcomp_seq(s) for s in keys])
    return (sum(1 for x in truths if x in joined),
            sum(1 for x in wrongs if x in joined))


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_sharded_wide_and_paired(results, name):
    ranks, ref, single = results
    got = ranks[0][name]
    assert_state_equal(got, ref[name])
    assert_state_equal(got, single[name])
    assert got["metrics"]["route_dropped"] == 0
    assert got["raw"] == ref[name]["raw"] == single[name]["raw"]
    assert got["clean"] == ref[name]["clean"] == single[name]["clean"]
    assert len(got["raw"]) > 0
    for r in ranks[1:]:
        assert r[name]["clean"] == got["clean"]
    if name == "k55":
        assert got["junctions"]["vals"][2].shape[1:] == (4,)
        assert got["node"] is None  # ext8: no branch-node cascade
        assert got["metrics"]["walk_route_bytes"] == 0
    if name == "paired":
        assert got["pair_counts"] == ref[name]["pair_counts"] \
            == single[name]["pair_counts"]
        assert len(got["pair_counts"]) > 0
        _, truths, wrongs = DR.phased_case()
        # contig sequences here are canonical; circular ones carry no
        # k-1 tail, which no truth needs
        assert _phasing(got["clean"], truths, wrongs) == (2, 0)
