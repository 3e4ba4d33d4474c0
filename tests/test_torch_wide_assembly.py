"""The benchmark cell saureus-k55-cut.assemble at a tiny size on the CPU:
the k = 55 whole two-pass assembly that the benchmark runs for the cell
(run.Assemble) equals the plain reference's load and scan; it and a
k = 31 one hold to their genomes, whose repeat unit is planted four
times (ROADMAP C3: the reference's pop_bubbles deletes a chunk between
two copies about half the time, and both of these genomes lost one
before the port's arm_key); the
graph build's pass 2 spans its window keying (build/pass2/keys) and
tallies its seeds and near-duplicates at k = 55 and at k = 31; the reader
of that span finds it, or nothing in a program without it; and
BENCHMARK.json's entries for the cell agree with its files."""
import json
import os

import pytest
import torch

from benchmark import check, gen, run

# the suite runs in several worker processes on few cores
torch.set_num_threads(1)

CELL = "saureus-k55-cut.assemble"
NARROW = "ecoli-k31.assemble"
READER = "pass2_keys_s.assemble"
PASS2 = ("pass2_seeds", "pass2_dups")


def _tiny(cell, genome_len, coverage=40.0, batch_reads=1024):
    spec = run.load_spec(cell)
    spec["config"].update(genome_len=genome_len, coverage=coverage,
                          batch_reads=batch_reads)
    return spec


def _assembled(cell, genome_len, seed, coverage=40.0):
    c = run.Assemble(_tiny(cell, genome_len, coverage), seed, "cpu")
    p, contigs = c.assemble()
    c.last = p
    return c, p, contigs


@pytest.fixture(scope="module")
def wide():
    """One assembly of the k = 55 cell: 12 kbp at the cell's 50x (at the
    20x of the benchmark's own CPU tests a k = 55 k-mer is seen ~9
    times, too few to assemble whole)."""
    return _assembled(CELL, 12_000, 2 ** 40 + 9, coverage=50.0)


@pytest.fixture(scope="module")
def narrow():
    """One assembly of ecoli-k31's configuration at 6 kbp, 40x."""
    return _assembled(NARROW, 6_000, 2 ** 40 + 9)


def test_the_configuration_is_the_k55_pass_with_its_genome_cut():
    spec = run.load_spec(CELL)
    cfg = spec["config"]
    assert spec["workload"]["passes"] == "assemble"
    assert spec["workload"]["chips"] == 1
    assert cfg["published_genome_len"] == 2_872_915 > cfg["genome_len"]
    assert set(cfg["reduced"]) == {"genome_len"}
    with open(os.path.join(run.HERE, "configs", "saureus-k55.json")) as f:
        whole = json.load(f)
    same = set(whole) - {"name", "source", "genome_len", "reduced",
                         "assumed"}
    assert {k: cfg[k] for k in same} == {k: whole[k] for k in same}
    # at 0.5 Mbp the genome and the reads are ecoli-k31's
    narrow = run.load_spec(NARROW)["config"]
    drawn = ("genome_len", "read_len", "coverage", "err_rate", "repeat_len",
             "min_repeats", "bp_per_repeat", "data_seed", "batch_reads")
    assert {k: cfg[k] for k in drawn} == {k: narrow[k] for k in drawn}
    assert cfg["k"] == 55 and narrow["k"] == 31


def test_the_cells_assembly_equals_the_reference(wide):
    c, p, contigs = wide
    assert c.pcfg.wide and p.node_cascade is None
    assert int(p.junctions.count) > 0 and contigs
    nums = check.state_numbers(c.state(), c.reference())
    assert nums == {"filter_words_differ": 0, "junction_rows_differ": 0,
                    "sink_rows_differ": 0}


@pytest.mark.parametrize("k", [31, 55])
def test_a_four_copy_repeat_keeps_every_chunk(wide, narrow, k):
    c, _, contigs = wide if k == 55 else narrow
    assert c.k == k and gen.n_repeats(c.spec["config"]) == 4
    nums = check.contig_numbers(contigs, c.genome, c.k,
                                gen.chunk_len(c.spec["config"]))
    assert check.verdict(nums), nums
    assert nums["contig_untrue_share"] == 0.0
    assert nums["genome_kmers_missing"] == 0


@pytest.mark.parametrize("k", [31, 55])
def test_pass2_spans_its_keys_and_tallies_its_seeds(wide, narrow, k):
    c, p, _ = wide if k == 55 else narrow
    assert c.k == k
    t, tally = p.metrics.timers, p.metrics.tally
    assert t["build/pass2/keys"] > 0
    assert t["build/pass2/keys"] < t["build/pass2"] - t["build/pass2/walk"]
    assert [x for x in t if x.endswith("/keys")] == ["build/pass2/keys"]
    assert set(PASS2) <= set(tally)
    assert tally["pass2_seeds"] > 0 <= tally["pass2_dups"]
    assert tally["pass2_dups"] < tally["pass2_seeds"]


def test_the_keys_reader_reads_the_span_or_nothing(wide):
    _, p, _ = wide
    t = dict(p.metrics.timers)
    ctx = {"assemblies": [t, {k: 2 * v for k, v in t.items()}]}
    got = run.read_metric(READER, ctx)
    assert got == pytest.approx(1.5 * t["build/pass2/keys"])
    assert got < run.read_metric("build_pass2_host_s.assemble", ctx)
    parent = {k: v for k, v in t.items() if not k.endswith("/keys")}
    assert run.read_metric(READER, {"assemblies": [parent]}) is None
    assert run.read_metric(READER, {}) is None


def test_benchmark_entries_of_the_cell_have_their_files():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = [x for x in bench["configs"] if x["name"] == "saureus-k55-cut"]
    assert len(cfg) == 1 and cfg[0]["reduced"] == ["genome_len"]
    with open(os.path.join(run.ROOT, cfg[0]["file"])) as f:
        assert json.load(f)["name"] == "saureus-k55-cut"
    cell = [w for w in bench["workloads"] if w["name"] == CELL]
    assert len(cell) == 1 and cell[0]["chips"] == 1
    spec = run.load_spec(CELL)
    assert spec["workload"]["config"] == cell[0]["config"]
    assert spec["workload"]["traffic"] == cell[0]["traffic"]
    _, per_layer = run.declared_metrics(CELL)
    assert per_layer
    for m in per_layer:
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           m["name"] + ".py"))
    # every assembly metric reads the new cell, the new one both cells
    mine = {m["name"] for m in per_layer}
    for m in bench["per_layer"]:
        if NARROW in m.get("workloads", []):
            assert m["name"] in mine
    keys = [m for m in bench["per_layer"] if m["name"] == READER]
    assert keys[0]["workloads"] == [NARROW, CELL]
    assert keys[0]["layer"] == "graph build host"
