"""The plain reference against the port at a tiny size on the CPU, and
the control: the reference with one hash fewer per filter (the
configuration's false-positive guarantee broken) in the program's place,
which the check has to find not correct."""
import pytest
import torch

from benchmark import check, gen, sizing
from benchmark.reference import Reference
from faucet_tpu_torch import Config, Metrics
from faucet_tpu_torch.pipeline import Pipeline

from benchmark.tests.helpers import tiny


def _program(spec, seed, stream):
    """The port's load and scan of a tiny cell, and its batches."""
    cfg = spec["config"]
    genome, reads = gen.make(cfg, seed, "cpu")
    kw = sizing.program_kwargs(cfg, reads.n_reads)
    p = Pipeline(Config(**kw), Metrics(), device="cpu")
    B = cfg["batch_reads"]
    batches = [(reads.bases[i:i + B], reads.lens[i:i + B])
               for i in range(0, reads.bases.shape[0], B)]
    if stream:
        for b, l in batches:
            p.stream_step(b, l.numpy())
        p.flush_junctions()
    else:
        p.load_batches((b.numpy(), l.numpy()) for b, l in batches)
        p.scan_batches((b.numpy(), l.numpy()) for b, l in batches)
    f = {"a": p.cascade.a_bloom.words, "b": p.cascade.b_bloom.words}
    if p.node_cascade is not None:
        f.update(d=p.node_cascade.a_bloom.words,
                 e=p.node_cascade.b_bloom.words)
    prog = {"filters": f, "junctions": check.table_rows(p.junctions, "cpu"),
            "sinks": check.table_rows(p.sinks, "cpu")}
    return prog, kw, batches, p


def _reference(kw, batches, stream, hash_delta=0):
    ref = Reference(kw, "cpu", hash_delta)
    for b, l in batches:
        (ref.stream if stream else ref.load)(b, l)
    if not stream:
        for b, l in batches:
            ref.scan(b, l)
    return ref


CASES = [("ecoli-k31.assemble", 31, False), ("ecoli-k31.assemble", 31, True),
         ("saureus-k55.ingest", 55, True), ("saureus-k55.ingest", 55, False)]


@pytest.mark.parametrize("cell,k,stream", CASES)
def test_reference_equals_the_port(cell, k, stream):
    prog, kw, batches, p = _program(tiny(cell), 2 ** 40 + 3, stream)
    assert kw["size_kmer"] == k and int(p.junctions.count) > 0
    nums = check.state_numbers(prog, _reference(kw, batches, stream))
    assert nums == {"filter_words_differ": 0, "junction_rows_differ": 0,
                    "sink_rows_differ": 0}


@pytest.mark.parametrize("cell,k,stream", CASES[1:3])
def test_control_is_not_correct(cell, k, stream):
    _, kw, batches, _ = _program(tiny(cell), 77, stream)
    good = _reference(kw, batches, stream)
    ctl = _reference(kw, batches, stream, hash_delta=-1)
    as_prog = {"filters": ctl.filter_words(),
               "junctions": ctl.tables()["junctions"],
               "sinks": ctl.tables()["sinks"]}
    nums = check.state_numbers(as_prog, good)
    assert nums["filter_words_differ"] > 0
    assert not check.verdict(nums)


def test_contig_numbers_against_the_genome():
    gen = torch.Generator().manual_seed(1)
    g = torch.randint(0, 4, (5000,), generator=gen, dtype=torch.uint8)
    s = check.genome_str(g)
    whole = check.contig_numbers([s[:3000], check.revcomp(s[2970:] + s[:40])],
                                 g, 31, 3000)
    assert whole == {"contig_untrue_share": 0.0, "genome_kmers_missing": 0,
                     "contig_n50_shortfall": 0.0}
    bad = s[:1000] + ("A" if s[1000] != "A" else "C") + s[1001:3000]
    nums = check.contig_numbers([bad, s[2970:] + s[:40]], g, 31, 3000)
    assert nums["contig_untrue_share"] == pytest.approx(3000 / 5070)
    # the 31 k-mers over the altered base
    assert nums["genome_kmers_missing"] == 31
    # the first contig's last base dropped: one k-mer missing
    cut = check.contig_numbers([s[:2999], s[2970:] + s[:40]], g, 31, 3000)
    assert cut["genome_kmers_missing"] == 1
    # split at 1,500 (overlapping by k - 1): every k-mer kept, N50 1,530
    split = check.contig_numbers([s[:1530], s[1500:3000], s[2970:] + s[:40]],
                                 g, 31, 3000)
    assert split["genome_kmers_missing"] == 0
    assert split["contig_n50_shortfall"] == pytest.approx(1 - 1530 / 3000)
