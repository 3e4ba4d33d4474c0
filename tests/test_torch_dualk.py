"""Dual-k (-second_kmer) in faucet_tpu_torch vs faucet_tpu.

The second pass reassembles the load reads plus the first pass's contigs,
chunked to read length, at a larger k. `contig_chunks` must equal the
reference's on the same graph (circular and short contigs included),
both CLIs must write byte-identical FASTA and GFA at k = 17 -> 25 and
k = 31 -> 55, and load reads from stdin are spooled to a temporary file
that no exit path leaves behind.
"""
import io
import sys
import types

import numpy as np
import pytest
import torch

from faucet_tpu import cli as jcli
from faucet_tpu import simulate
from faucet_tpu.graph import model as JM
from faucet_tpu.pipeline import contig_chunks as jchunks
from faucet_tpu_torch import cli as tcli
from faucet_tpu_torch import pipeline as TP
from faucet_tpu_torch.graph import model as TM

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

SPOOL_PREFIX = "faucet_tpu_torch_spool_"


def _graph(M, k, seqs):
    """A ContigGraph of module M: a linear contig per seq, the second
    circular, the last deleted."""
    cs = [M.Contig(seq=s, cov=3.0, circular=(i == 1),
                   deleted=(i == len(seqs) - 1)) for i, s in enumerate(seqs)]
    return M.ContigGraph(k, cs)


@pytest.mark.parametrize("max_len,k2", [(100, 25), (100, 55), (60, 55),
                                        (150, 31)])
def test_contig_chunks_equal_reference(rng, max_len, k2):
    """Long, circular, shorter-than-k2 and deleted contigs, and one of
    exactly k2 bases, carried across: the same chunks in the same order."""
    lens = (1000, 300, k2 - 1, k2, 7, 2 * max_len + 3, 400)
    seqs = [simulate.random_genome(rng, n) for n in lens]
    want = jchunks(_graph(JM, 21, seqs), max_len, k2)
    got = TP.contig_chunks(_graph(TM, 21, seqs), max_len, k2)
    assert got == want and got
    # every chunk twice, each at least k2 and at most max_len long
    assert got[0::2] == got[1::2]
    assert all(k2 <= len(c) <= max_len for c in got)


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    """tests/test_torch_pipeline.py's repeat case: 3,000 bp, two 200 bp
    repeats, 40x 100 bp reads at 0.5% errors."""
    rng = np.random.default_rng(777)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=40, read_len=100,
                           err_rate=0.005, circular=True)
    tmp = tmp_path_factory.mktemp("dualk")
    simulate.write_fasta(str(tmp / "reads.fa"), reads)
    return tmp / "reads.fa"


def _args(fa, load, prefix, k1, k2, *extra):
    return ["-read_load_file", load, "-read_scan_file", str(fa),
            "-size_kmer", str(k1), "-second_kmer", str(k2),
            "-max_read_length", "100", "-estimated_kmers", str(1 << 15),
            "-singletons", str(1 << 15), "--batch_reads", "256",
            "--no_native", "-file_prefix", str(prefix), *extra]


@pytest.fixture
def spool_dir(tmp_path, monkeypatch):
    """Temporary files (the spool) go to a directory of their own."""
    import tempfile

    d = tmp_path / "spool"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def _stdin(monkeypatch, fa):
    monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
        buffer=io.BytesIO(fa.read_bytes())))


@pytest.mark.parametrize("k1,k2", [(17, 25), (31, 55)])
def test_dualk_cli_byte_identical(reads_fa, tmp_path, k1, k2, capsys):
    """Both CLIs, file input: the final FASTA and GFA (the k2 graph,
    under the original prefix) are byte-identical."""
    fa = str(reads_fa)
    assert jcli.main(_args(fa, fa, tmp_path / "j", k1, k2)) == 0
    assert tcli.main(_args(fa, fa, tmp_path / "t", k1, k2,
                           "--device", "cpu")) == 0
    err = capsys.readouterr().err
    assert f"[faucet_tpu_torch] dual-k second pass at k={k2}" in err
    for ext in ("fasta", "gfa"):
        j = (tmp_path / f"j.{ext}").read_bytes()
        assert j and (tmp_path / f"t.{ext}").read_bytes() == j, ext
    # the output is the k2 graph: its GFA links overlap by k2 - 1 bases
    assert f"\t{k2 - 1}M" in (tmp_path / "t.gfa").read_text()


def test_dualk_stdin_spools_and_cleans_up(reads_fa, tmp_path, spool_dir,
                                          monkeypatch, capsys):
    """-read_load_file - : the load reads are spooled, the run equals the
    file run byte for byte, and the spool file is gone afterwards."""
    fa = str(reads_fa)
    assert tcli.main(_args(fa, fa, tmp_path / "file", 17, 25,
                           "--device", "cpu")) == 0
    _stdin(monkeypatch, reads_fa)
    assert tcli.main(_args(fa, "-", tmp_path / "pipe", 17, 25,
                           "--device", "cpu")) == 0
    err = capsys.readouterr().err
    assert "dual-k on a pipe: spooled load reads to " + str(
        spool_dir / SPOOL_PREFIX) in err
    assert "dual-k second pass at k=25" in err
    assert list(spool_dir.iterdir()) == []
    for ext in ("fasta", "gfa"):
        assert (tmp_path / f"pipe.{ext}").read_bytes() == \
            (tmp_path / f"file.{ext}").read_bytes()


def test_dualk_spool_removed_when_second_pass_raises(reads_fa, tmp_path,
                                                     spool_dir, monkeypatch,
                                                     capsys):
    def boom(*a, **kw):
        raise RuntimeError("second pass failed")

    monkeypatch.setattr(TP, "contig_chunks", boom)
    _stdin(monkeypatch, reads_fa)
    with pytest.raises(RuntimeError, match="second pass failed"):
        tcli.main(_args(str(reads_fa), "-", tmp_path / "x", 17, 25,
                        "--device", "cpu"))
    assert "spooled load reads" in capsys.readouterr().err
    assert list(spool_dir.iterdir()) == []


def test_dualk_spool_removed_when_copy_fails(reads_fa, spool_dir,
                                             monkeypatch):
    """A copy cut short (here a broken pipe halfway) leaves no spool file
    behind either."""
    import shutil

    def broken(src, dst):
        dst.write(src.read(100))
        raise BrokenPipeError("stdin closed")

    monkeypatch.setattr(shutil, "copyfileobj", broken)
    _stdin(monkeypatch, reads_fa)
    with pytest.raises(BrokenPipeError):
        tcli._spool("-")
    assert list(spool_dir.iterdir()) == []
