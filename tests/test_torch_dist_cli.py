"""The port's sharded CLI on the CPU: `python -m faucet_tpu_torch.cli
--device cpu --n_shards 4`, with and without `--distributed_clean`, writes
the reference CLI's FASTA and GFA bytes (same flags, `--platform cpu`).
"""

import pytest
import torch

from faucet_tpu import cli as jcli
from faucet_tpu_torch import cli as tcli

import torch_dist_ranks as DR
from torch_dist_ref import FLAGS, _io, cli_inputs

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    return cli_inputs(tmp_path_factory.mktemp("dist_cli"))


@pytest.mark.parametrize("extra", [[], ["--distributed_clean"]],
                         ids=["clean", "distributed_clean"])
def test_cli_n_shards_matches_reference(reads_fa, extra):
    d, tag = reads_fa, "dc" if extra else "c"
    shard = ["--n_shards", "4", "--batch_reads", "64"] + extra
    join = DR.in_background(tcli.main, _io(d, f"t_{tag}") + FLAGS + shard
                            + ["--device", "cpu"])
    assert jcli.main(_io(d, f"j_{tag}") + FLAGS + shard
                     + ["--platform", "cpu"]) == 0
    assert join() == 0
    for ext in ("fasta", "gfa"):
        got = (d / f"t_{tag}.{ext}").read_bytes()
        assert got == (d / f"j_{tag}.{ext}").read_bytes()
    assert got.count(b"\n") > 0


def test_cli_sharded_dualk_matches_reference(reads_fa):
    """-second_kmer: the second pass runs sharded too."""
    d = reads_fa
    flags = FLAGS + ["--n_shards", "2", "--batch_reads", "64",
                     "-second_kmer", "25"]
    join = DR.in_background(tcli.main, _io(d, "t_dk") + flags
                            + ["--device", "cpu"])
    assert jcli.main(_io(d, "j_dk") + flags + ["--platform", "cpu"]) == 0
    assert join() == 0
    got = (d / "t_dk.fasta").read_bytes()
    assert got == (d / "j_dk.fasta").read_bytes() and got.count(b">") > 0


def test_cli_sharded_resume(reads_fa):
    """A sharded run's checkpoints (the gathered global arrays, written by
    rank 0) resume at the same n_shards, each rank taking its slices, to
    the same FASTA; the reference resumes from them too."""
    d = reads_fa
    flags = FLAGS + ["--n_shards", "2", "--batch_reads", "64"]
    assert tcli.main(_io(d, "t_ck") + flags + ["--device", "cpu"]) == 0
    ck = ["-bloom_file", str(d / "t_ck.bloom.npz"), "-junctions_file",
          str(d / "t_ck.junctions.npz")]
    base = [a for a in flags]
    assert tcli.main(ck + base + ["-file_prefix", str(d / "t_rs"),
                                  "--device", "cpu"]) == 0
    assert jcli.main(ck + base + ["-file_prefix", str(d / "j_rs"),
                                  "--platform", "cpu"]) == 0
    want = (d / "t_ck.fasta").read_bytes()
    assert (d / "t_rs.fasta").read_bytes() == want
    assert (d / "j_rs.fasta").read_bytes() == want
