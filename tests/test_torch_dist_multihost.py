"""Multi-host runs of the port on the CPU: two "host" processes x 2 ranks
of 4, joined over TCP on localhost, each feeding its half of the reads
(tests/dist/test_multihost.py:39).

- Library level: both hosts print the same contig digest, equal to the
  single-process 4-rank run's.
- Through the CLI (`--coordinator`, `--num_processes`, `--process_id`,
  each host reading its own file): the FASTA equals the reference CLI's on
  all the reads, whose batches are the two hosts' batches side by side.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch

from faucet_tpu import cli as jcli
from faucet_tpu_torch.dist.mesh import spawn

import torch_dist_ranks as DR
from torch_dist_ref import FLAGS, _io, cli_inputs

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TESTS = os.path.join(_REPO, "tests")


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    return cli_inputs(tmp_path_factory.mktemp("dist_multihost"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO, _TESTS] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def test_two_hosts_agree_with_one():
    """Library level: each host process starts its 2 ranks of 4."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_dist_ranks as D; D.host_main({h}, {port})"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for h in range(2)]
    lines = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        lines += [l for l in out.splitlines() if l.startswith("RESULT")]
    assert len(lines) == 4 and len(set(lines)) == 1
    one = spawn(DR.digest_rank, 4, args=(False,), threads=1, timeout=300)
    assert {f"RESULT {n} {h}" for n, h in one} == set(lines)
    assert int(lines[0].split()[1]) >= 3


def test_two_host_cli_matches_reference(reads_fa):
    d, port = reads_fa, _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "faucet_tpu_torch.cli",
         *_io(d, "t_mh", f"half{h}.fa"), *FLAGS, "--n_shards", "4",
         "--batch_reads", "64", "--device", "cpu",
         "--coordinator", f"localhost:{port}", "--num_processes", "2",
         "--process_id", str(h)],
        env=_env(), cwd=str(d), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for h in range(2)]
    assert jcli.main(_io(d, "j_mh") + FLAGS + [
        "--n_shards", "4", "--batch_reads", "128", "--platform", "cpu"]) == 0
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    assert (d / "t_mh.fasta").read_bytes() == (d / "j_mh.fasta").read_bytes()
