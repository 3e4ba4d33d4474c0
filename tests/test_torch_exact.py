"""Exact mode (cfg.exact, --exact) of faucet_tpu_torch vs faucet_tpu and
the golden model.

In exact mode the cascade's A and B (and the branch-node cascade's D and
E) are hash tables, not Blooms. The same numpy-seeded reads go through
both packages on the CPU: the cascade, node-cascade, junction and sink
tables must agree slot for slot in file and stream modes at k = 21 and
k = 55; contigs must equal refimpl/numpy_exact.py's ExactAssembler, as
tests/golden/test_pipeline.py and test_wide_k.py hold the reference to
it; nodes must equal ext8 (tests/golden/test_junction_modes.py); and an
exact checkpoint written by either package must resume in the other.
Integer data throughout: every comparison is exact.
"""
import numpy as np
import pytest
import torch

from faucet_tpu import cli as jcli
from faucet_tpu import simulate
from faucet_tpu.config import Config as JConfig
from faucet_tpu.pipeline import Pipeline as JPipeline
from faucet_tpu_torch import cli as tcli
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.config import Config as TConfig
from faucet_tpu_torch.core import wide as TW
from faucet_tpu_torch.core.kmer import decode_kmer
from faucet_tpu_torch.graph.build import extract_table
from faucet_tpu_torch.pipeline import Pipeline as TPipeline
from refimpl.numpy_exact import ExactAssembler

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)


def _kw(k, **kw):
    """tests/golden/test_pipeline.py's configuration (k = 21) and
    test_wide_k.py's (k = 55), in exact mode."""
    base = dict(size_kmer=k, max_read_length=100 if k <= 31 else 120,
                batch_reads=64, exact=True, estimated_kmers=1 << 14,
                singletons=1 << 14,
                junction_capacity=1 << 13 if k <= 31 else 1 << 12,
                sink_capacity=1 << 13 if k <= 31 else 1 << 14,
                fp_rate=0.002)
    base.update(kw)
    return base


def _reads(k, err_rate=0.005):
    """The golden tests' genome for k (3,000 bp with two 200 bp repeats,
    or 2,500 bp with two of 220 at k = 55) as 40x reads."""
    if k <= 31:
        rng = np.random.default_rng(777)
        genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                              repeat_len=200)
        L = 100
    else:
        rng = np.random.default_rng(808)
        genome = simulate.genome_with_repeats(rng, 2500, n_repeats=2,
                                              repeat_len=220)
        L = 120
    return genome, simulate.shred(rng, genome, coverage=40, read_len=L,
                                  err_rate=err_rate, circular=True)


def _contigs(g):
    return sorted((g.contigs[i].canonical_seq(), g.contigs[i].cov,
                   g.contigs[i].circular) for i in g.live())


def _same_table(t, j, name):
    """Port table == reference table, slot for slot (TRASH row dropped;
    values compared as integers, so dtypes need not match)."""
    d = CK.table_to_numpy(t)
    for f in ("keys_hi", "keys_lo", "count", "dropped"):
        np.testing.assert_array_equal(d[f], np.asarray(getattr(j, f)),
                                      err_msg=f"{name}.{f}")
    assert len(d["vals"]) == len(j.vals), name
    for i, (a, b) in enumerate(zip(d["vals"], j.vals)):
        np.testing.assert_array_equal(a.astype(np.int64),
                                      np.asarray(b).astype(np.int64),
                                      err_msg=f"{name}.val{i}")


@pytest.mark.parametrize("k,mode", [(21, "file"), (21, "stream"),
                                    (55, "file"), (55, "stream")])
def test_exact_tables_equal_reference(k, mode):
    """Every table of the run, cascade and node cascade included, equals
    faucet_tpu's slot for slot; contigs and counters are identical."""
    _, reads = _reads(k)
    jp, tp = JPipeline(JConfig(**_kw(k))), TPipeline(TConfig(**_kw(k)),
                                                     device="cpu")
    if mode == "file":
        jg, tg = jp.run_file_mode(reads, reads), tp.run_file_mode(reads,
                                                                  reads)
    else:
        jg, tg = jp.run_streaming(reads), tp.run_streaming(reads)
    assert int(jp.cascade.b_table.count) > 0
    # the Blooms are the reference's dummies: 2**9 bits each
    assert tp.cascade.a_bloom.words.numel() == \
        np.asarray(jp.cascade.a_bloom.words).size == 16
    for name in ("a_table", "b_table"):
        _same_table(getattr(tp.cascade, name), getattr(jp.cascade, name),
                    name)
    assert (tp.node_cascade is None) == (jp.node_cascade is None) == \
        (k > 31)
    if k <= 31:
        for name in ("a_table", "b_table"):
            _same_table(getattr(tp.node_cascade, name),
                        getattr(jp.node_cascade, name), "node " + name)
    _same_table(tp.junctions, jp.junctions, "junctions")
    _same_table(tp.sinks, jp.sinks, "sinks")
    assert _contigs(tg) == _contigs(jg) and _contigs(tg)
    assert tp.metrics.counters == jp.metrics.counters


@pytest.mark.parametrize("k", [21, 55])
def test_exact_contigs_equal_golden_model(k):
    """Error-free reads: the junction and sink tables and the uncleaned
    contigs equal refimpl/numpy_exact.py's, as the golden tests hold the
    reference to them."""
    _, reads = _reads(k, err_rate=0.0)
    asm = ExactAssembler(k)
    asm.load(reads)
    asm.scan(reads)
    p = TPipeline(TConfig(**_kw(k)), device="cpu")
    p.load_reads(reads)
    p.scan_reads(reads)
    jt = extract_table(p.junctions)
    dev = {}
    for i in range(len(jt["hi"])):
        node = (decode_kmer(int(jt["hi"][i]), int(jt["lo"][i]), k)
                if k <= 31 else TW.decode_kmer_wide(jt["v2"][i], k))
        dev[node] = (jt["v0"][i].tolist(), jt["v1"][i].astype(int).tolist())
    ref = {n: (j["cov"], j["dist"]) for n, j in asm.junctions.items()}
    assert dev == ref and ref
    if k <= 31:
        st = extract_table(p.sinks)
        assert {decode_kmer(int(h), int(lo), k): int(v) for h, lo, v in
                zip(st["hi"], st["lo"], st["v0"])} == asm.sinks
    g_ref, g_dev = asm.build(), p.build()
    keys = lambda g: sorted(g.contigs[i].canonical_seq() for i in g.live())
    assert keys(g_dev) == keys(g_ref)
    ref_cov = {g_ref.contigs[i].canonical_seq(): g_ref.contigs[i].cov
               for i in g_ref.live()}
    for i in g_dev.live():
        c = g_dev.contigs[i]
        assert ref_cov[c.canonical_seq()] == pytest.approx(c.cov)


def test_exact_nodes_equals_ext8():
    """tests/golden/test_junction_modes.py on the port: in exact mode the
    branch-node cascade and the 8-way extension probe find the same
    junctions and emit the same contigs."""
    rng = np.random.default_rng(4242)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=40, read_len=100,
                           circular=True)
    out = {}
    for mode in ("nodes", "ext8"):
        p = TPipeline(TConfig(**_kw(21, junction_detect=mode)),
                      device="cpu")
        assert (p.node_cascade is not None) == (mode == "nodes")
        g = p.run_file_mode(reads, reads)
        jt = extract_table(p.junctions)
        out[mode] = (sorted(zip(jt["hi"].tolist(), jt["lo"].tolist())),
                     sorted(g.contigs[i].canonical_seq() for i in g.live()))
    assert out["nodes"] == out["ext8"] and out["nodes"][0]


def _args(tmp, prefix, *extra):
    return ["-read_load_file", str(tmp / "reads.fa"), "-read_scan_file",
            str(tmp / "reads.fa"), "-size_kmer", "21",
            "-max_read_length", "100", "-estimated_kmers", str(1 << 15),
            "-singletons", str(1 << 15), "--batch_reads", "256",
            "--no_native", "--exact", "-file_prefix", str(tmp / prefix),
            *extra]


@pytest.fixture(scope="module")
def exact_cli(tmp_path_factory):
    """Both CLIs with --exact on the same FASTA."""
    tmp = tmp_path_factory.mktemp("exact_cli")
    simulate.write_fasta(str(tmp / "reads.fa"), _reads(21)[1])
    assert jcli.main(_args(tmp, "j")) == 0
    assert tcli.main(_args(tmp, "t", "--device", "cpu")) == 0
    return tmp


def test_exact_cli_byte_identical(exact_cli):
    """FASTA, GFA and both checkpoints (the at_/bt_ tables full size, the
    Blooms dummies) equal the reference's."""
    tmp = exact_cli
    for ext in ("fasta", "gfa"):
        j = (tmp / f"j.{ext}").read_bytes()
        assert j and (tmp / f"t.{ext}").read_bytes() == j, ext
    for ext in ("bloom.npz", "junctions.npz"):
        zj, zt = np.load(tmp / f"j.{ext}"), np.load(tmp / f"t.{ext}")
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            assert zj[f].dtype == zt[f].dtype, f
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)
    z = np.load(tmp / "t.bloom.npz")
    assert z["a_words"].size == 16 and int(z["bt_count"]) > 0


@pytest.mark.parametrize("writer", ["j", "t"])
def test_exact_checkpoint_resumes_in_the_other_package(exact_cli, writer):
    tmp = exact_cli
    ck = ["-bloom_file", str(tmp / f"{writer}.bloom.npz"),
          "-junctions_file", str(tmp / f"{writer}.junctions.npz")]
    prefix = f"resumed_{writer}"
    if writer == "j":
        assert tcli.main(_args(tmp, prefix, *ck, "--device", "cpu")) == 0
    else:
        assert jcli.main(_args(tmp, prefix, *ck)) == 0
    for ext in ("fasta", "gfa"):
        assert (tmp / f"{prefix}.{ext}").read_bytes() == \
            (tmp / f"j.{ext}").read_bytes()
