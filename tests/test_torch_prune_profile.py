"""prune_slots, --profile and the checkpoint loaders' device in
faucet_tpu_torch, against faucet_tpu where the reference has the same
function.

`prune_slots` (dist/sharded.py) zeroes the junction slots below a
coverage floor; on a junction table carried across and through the whole
Pipeline (prune_slot_cov = 2) the port equals the reference exactly.
`--profile` writes a torch.profiler Chrome trace and leaves the outputs
unchanged. The checkpoint loaders run on the card unless the caller asks
for the CPU.
"""
import json

import numpy as np
import pytest
import torch

from faucet_tpu import simulate
from faucet_tpu.config import Config as JConfig
from faucet_tpu.core import table as JT
from faucet_tpu.dist.sharded import prune_slots as jprune
from faucet_tpu.pipeline import Pipeline as JPipeline
from faucet_tpu_torch import cli as tcli
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.config import Config as TConfig
from faucet_tpu_torch.core import bloom as TBL
from faucet_tpu_torch.core import table as TT
from faucet_tpu_torch.dist.sharded import prune_slots as tprune
from faucet_tpu_torch.pipeline import Pipeline as TPipeline

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

K = 21


def _kw(**kw):
    base = dict(size_kmer=K, max_read_length=100, batch_reads=64,
                estimated_kmers=1 << 14, singletons=1 << 14,
                junction_capacity=1 << 13, sink_capacity=1 << 13,
                fp_rate=0.002)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def reads():
    """tests/test_torch_pipeline.py's repeat case (0.5% errors)."""
    rng = np.random.default_rng(777)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    return simulate.shred(rng, genome, coverage=40, read_len=100,
                          err_rate=0.005, circular=True)


@pytest.mark.parametrize("floor", [2, 3, 5])
def test_prune_slots_equals_reference(rng, floor):
    """A junction table of random keys, cov8 and dist8 (occupied and
    empty slots), carried across: the same table after pruning, dist8
    untouched."""
    cap = 256
    hi = rng.integers(0, 1 << 30, cap).astype(np.uint32)
    occupied = rng.random(cap) < 0.6
    hi[~occupied] = 0xFFFFFFFF
    jt = JT.Table(
        keys_hi=hi, keys_lo=rng.integers(0, 1 << 32, cap,
                                         dtype=np.uint64).astype(np.uint32),
        vals=(rng.integers(0, 6, (cap, 8)).astype(np.int32),
              rng.integers(0, 1 << 16, (cap, 8)).astype(np.uint16)),
        count=np.int32(occupied.sum()), dropped=np.int32(0))
    want = jprune(jt, floor)
    got = CK.table_to_numpy(tprune(CK.table_from_numpy(jt), floor),
                            (np.int32, np.uint16))
    for f in ("keys_hi", "keys_lo", "count", "dropped"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    for a, b in zip(got["vals"], want.vals):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (got["vals"][0] == 0).sum() > (jt.vals[0] == 0).sum()


@pytest.mark.parametrize("mode", ["file", "stream"])
@pytest.mark.parametrize("floor", [2, 4])
def test_prune_pipeline_equals_reference(reads, mode, floor):
    """Pipeline(prune_slot_cov=floor): identical contigs, junction and
    sink tables and counters. This case has no slot of coverage 1 (an
    erroneous k-mer is not solid), so the floor of 2 prunes nothing; the
    floor of 4 prunes the slots of coverage 2 and 3."""
    kw = _kw(prune_slot_cov=floor)
    jp, tp = JPipeline(JConfig(**kw)), TPipeline(TConfig(**kw),
                                                 device="cpu")
    if mode == "file":
        jg, tg = jp.run_file_mode(reads, reads), tp.run_file_mode(reads,
                                                                  reads)
    else:
        jg, tg = jp.run_streaming(reads), tp.run_streaming(reads)
    key = lambda g: sorted((g.contigs[i].canonical_seq(), g.contigs[i].cov)
                           for i in g.live())
    assert key(tg) == key(jg) and key(tg)
    assert tp.metrics.counters == jp.metrics.counters
    for t, j in ((tp.junctions, jp.junctions), (tp.sinks, jp.sinks)):
        d = CK.table_to_numpy(t)
        for f in ("keys_hi", "keys_lo", "count", "dropped"):
            np.testing.assert_array_equal(d[f], np.asarray(getattr(j, f)))
        for a, b in zip(d["vals"], j.vals):
            np.testing.assert_array_equal(a.astype(np.int64),
                                          np.asarray(b).astype(np.int64))
    cov8 = tp.junctions.vals[0][:-1]
    assert not ((cov8 > 0) & (cov8 < floor)).any()
    unpruned = TPipeline(TConfig(**_kw()), device="cpu")
    unpruned.run_file_mode(reads, reads)
    cov8 = unpruned.junctions.vals[0][:-1]
    assert bool(((cov8 > 0) & (cov8 < floor)).any()) == (floor > 2)


def _cli_args(tmp, prefix, *extra):
    return ["-read_load_file", str(tmp / "reads.fa"), "-read_scan_file",
            str(tmp / "reads.fa"), "-size_kmer", str(K),
            "-max_read_length", "100", "-estimated_kmers", str(1 << 15),
            "-singletons", str(1 << 15), "--batch_reads", "256",
            "--no_native", "--device", "cpu", "-file_prefix",
            str(tmp / prefix), *extra]


def test_profile_writes_chrome_trace(reads, tmp_path, capsys):
    """--profile --device cpu: {prefix}.trace/ holds a Chrome trace that
    parses and has the run's events; FASTA and GFA are byte-identical to
    a run without --profile."""
    simulate.write_fasta(str(tmp_path / "reads.fa"), reads)
    assert tcli.main(_cli_args(tmp_path, "plain")) == 0
    assert tcli.main(_cli_args(tmp_path, "prof", "--profile")) == 0
    trace_dir = tmp_path / "prof.trace"
    assert (f"[faucet_tpu_torch] profile trace in {trace_dir}"
            in capsys.readouterr().err)
    files = list(trace_dir.iterdir())
    assert [f.name for f in files] == ["trace.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert len(events) > 100
    assert any(e.get("name", "").startswith("aten::") for e in events)
    for ext in ("fasta", "gfa"):
        assert (tmp_path / f"prof.{ext}").read_bytes() == \
            (tmp_path / f"plain.{ext}").read_bytes()
    assert not (tmp_path / "plain.trace").exists()


def test_checkpoint_loaders_default_to_cuda(tmp_path):
    """load_bloom and load_junctions run on the card unless asked for the
    CPU: without a card, the default raises naming cuda; device="cpu"
    loads."""
    cfg = TConfig(**_kw())
    dev = torch.device("cpu")
    CK.save_bloom(str(tmp_path / "b.npz"), cfg, TBL.make_cascade(cfg, dev),
                  TBL.make_cascade(cfg.node_view(), dev))
    j = TT.make(cfg.junction_cap, (((8,), torch.int32),
                                   ((8,), torch.int32)), device=dev)
    s = TT.make(cfg.sink_cap, (((), torch.int32),), device=dev)
    CK.save_junctions(str(tmp_path / "j.npz"), cfg, j, s)
    cascade, node = CK.load_bloom(str(tmp_path / "b.npz"), cfg, "cpu")
    assert cascade.a_bloom.words.device == dev and node is not None
    jt, st, pairs = CK.load_junctions(str(tmp_path / "j.npz"), cfg, "cpu")
    assert jt.keys_hi.device == dev and pairs is None
    if torch.cuda.is_available():
        cascade, _ = CK.load_bloom(str(tmp_path / "b.npz"), cfg)
        assert cascade.a_bloom.words.is_cuda
        assert CK.load_junctions(str(tmp_path / "j.npz"), cfg)[0] \
            .keys_hi.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        CK.load_bloom(str(tmp_path / "b.npz"), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        CK.load_junctions(str(tmp_path / "j.npz"), cfg)
