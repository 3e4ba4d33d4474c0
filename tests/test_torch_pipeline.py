"""The whole slice: faucet_tpu_torch's Pipeline and CLI vs faucet_tpu's.

On the golden tests' repeat genome both packages must assemble identical
contigs in two-pass and single-pass modes, both CLIs must write
byte-identical FASTA and GFA and equal checkpoints, and a checkpoint
written by either package must resume in the other.
"""
import numpy as np
import pytest
import torch

from faucet_tpu import cli as jcli
from faucet_tpu import simulate
from faucet_tpu.config import Config
from faucet_tpu.pipeline import Pipeline as JPipeline
from faucet_tpu_torch import cli as tcli
from faucet_tpu_torch.pipeline import Pipeline as TPipeline

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

K = 21


def _cfg(**kw):
    base = dict(size_kmer=K, max_read_length=100, batch_reads=64,
                estimated_kmers=1 << 14, singletons=1 << 14,
                junction_capacity=1 << 13, sink_capacity=1 << 13,
                fp_rate=0.002)
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def repeat_case():
    """tests/golden/test_pipeline.py's repeat_case, plus 0.5% errors."""
    rng = np.random.default_rng(777)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=40, read_len=100,
                           err_rate=0.005, circular=True)
    return genome, reads


def _contigs(g):
    return sorted((g.contigs[i].canonical_seq(), g.contigs[i].cov,
                   g.contigs[i].circular) for i in g.live())


@pytest.mark.parametrize("mode", ["file", "stream"])
def test_pipeline_identical_contigs(repeat_case, mode):
    genome, reads = repeat_case
    jp, tp = JPipeline(_cfg()), TPipeline(_cfg(), device="cpu")
    if mode == "file":
        jg, tg = jp.run_file_mode(reads, reads), tp.run_file_mode(reads,
                                                                  reads)
    else:
        jg, tg = jp.run_streaming(reads), tp.run_streaming(reads)
    assert _contigs(tg) == _contigs(jg)
    assert tp.metrics.counters == jp.metrics.counters
    doubled = genome + genome
    for s, _, _ in _contigs(tg):
        assert s in doubled or simulate.revcomp_seq(s) in doubled


def _args(tmp, prefix, *extra):
    return ["-read_load_file", str(tmp / "reads.fa"), "-size_kmer", str(K),
            "-max_read_length", "100", "-estimated_kmers", str(1 << 15),
            "-singletons", str(1 << 15), "--batch_reads", "256",
            "-file_prefix", str(tmp / prefix), *extra]


@pytest.fixture(scope="module")
def cli_runs(repeat_case, tmp_path_factory):
    """Both CLIs, two-pass and --stream, on the same FASTA."""
    tmp = tmp_path_factory.mktemp("cli")
    simulate.write_fasta(str(tmp / "reads.fa"), repeat_case[1])
    scan = ["-read_scan_file", str(tmp / "reads.fa")]
    for name, extra in (("two", scan), ("stream", ["--stream"])):
        assert jcli.main(_args(tmp, f"j_{name}", *extra)) == 0
        assert tcli.main(_args(tmp, f"t_{name}", *extra,
                               "--device", "cpu")) == 0
    return tmp


@pytest.mark.parametrize("mode", ["two", "stream"])
def test_cli_byte_identical(cli_runs, mode):
    tmp = cli_runs
    for ext in ("fasta", "gfa"):
        j = (tmp / f"j_{mode}.{ext}").read_bytes()
        assert j and (tmp / f"t_{mode}.{ext}").read_bytes() == j, ext
    for ext in ("bloom.npz", "junctions.npz"):
        zj, zt = np.load(tmp / f"j_{mode}.{ext}"), np.load(
            tmp / f"t_{mode}.{ext}")
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            assert zj[f].dtype == zt[f].dtype, f
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)


@pytest.mark.parametrize("writer", ["j", "t"])
def test_checkpoint_resumes_in_the_other_package(cli_runs, writer):
    tmp = cli_runs
    ck = ["-bloom_file", str(tmp / f"{writer}_two.bloom.npz"),
          "-junctions_file", str(tmp / f"{writer}_two.junctions.npz")]
    if writer == "j":
        assert tcli.main(_args(tmp, "resumed", *ck, "--device", "cpu")) == 0
    else:
        assert jcli.main(_args(tmp, "resumed", *ck)) == 0
    for ext in ("fasta", "gfa"):
        assert (tmp / f"resumed.{ext}").read_bytes() == \
            (tmp / f"j_two.{ext}").read_bytes()


@pytest.mark.parametrize("flags", [
    ["--paired_ends"], ["--exact"], ["--junction_detect", "ext8"],
    ["-size_kmer", "33"], ["--n_shards", "2"], ["-second_kmer", "25"],
    ["--coordinator", "localhost:1234"], ["--profile"],
])
def test_cli_unported_flags_exit_nonzero(tmp_path, capsys, flags):
    rc = tcli.main(["-read_load_file", "x.fa", "--stream", *flags])
    assert rc != 0
    assert "ROADMAP.md" in capsys.readouterr().err


def test_unported_config_and_missing_card_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TPipeline(_cfg(exact=True), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TPipeline(_cfg(junction_detect="ext8"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TPipeline(_cfg(), device="cuda")
