"""faucet_tpu_torch scan (core/scan.py) vs the faucet_tpu reference.

Both packages start from one state (the reference's, converted with the
ckpt/state.py *_from_numpy functions) and run the same batches; junction
tables, sink tables, spools and filters must be bit-identical, slot
arrays included. Integer data throughout, so equality is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faucet_tpu import simulate
from faucet_tpu.config import Config
from faucet_tpu.core import bloom as JBL
from faucet_tpu.core import scan as JSC
from faucet_tpu.core import table as JT
from faucet_tpu.core.kmer import pack_reads
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.core import scan as TSC

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

_jscan = jax.jit(JSC.scan_batch, static_argnames=("cfg",))
_jload = jax.jit(JSC.load_batch_nodes_s, static_argnames=("cfg",))
_jflush = jax.jit(JSC.spool_flush, static_argnames=("cfg",))


def _cfg(**kw):
    base = dict(size_kmer=21, max_read_length=60, batch_reads=48,
                estimated_kmers=1 << 12, singletons=1 << 12,
                junction_capacity=1 << 10, sink_capacity=1 << 12,
                fp_rate=0.01)
    base.update(kw)
    return Config(**base)


def _reads(coverage, err):
    rng = np.random.default_rng(21)
    genome = simulate.genome_with_repeats(rng, 1200, n_repeats=2,
                                          repeat_len=100)
    reads = simulate.shred(rng, genome, coverage=coverage, read_len=60,
                           err_rate=err, circular=True)
    return reads + ["", "ACGTN" * 12, "ACGT"]  # empty, N-bearing, short


@pytest.fixture(scope="module")
def reads():
    return _reads(12, 0.01)


def _batches(reads, cfg):
    B = cfg.batch_reads
    return [pack_reads(reads[i:i + B] + [""] * (B - len(reads[i:i + B])),
                       cfg.max_read_length)
            for i in range(0, len(reads), B)]


def _same_table(tt, jt):
    d = CK.table_to_numpy(tt, [np.asarray(v).dtype for v in jt.vals])
    np.testing.assert_array_equal(d["keys_hi"], np.asarray(jt.keys_hi))
    np.testing.assert_array_equal(d["keys_lo"], np.asarray(jt.keys_lo))
    for g, w in zip(d["vals"], jt.vals):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert int(d["count"]) == int(jt.count)
    assert int(d["dropped"]) == int(jt.dropped)


def _same_cascade(tc, jc):
    np.testing.assert_array_equal(CK.words_to_numpy(tc.a_bloom.words),
                                  np.asarray(jc.a_bloom.words))
    np.testing.assert_array_equal(CK.words_to_numpy(tc.b_bloom.words),
                                  np.asarray(jc.b_bloom.words))


def _same_spool(ts, js):
    d = CK.spool_to_numpy(ts)
    for f in ("khi", "klo", "sf", "dd"):
        np.testing.assert_array_equal(d[f], np.asarray(getattr(js, f)))
    assert int(d["cnt"]) == int(js.cnt)


class _Both:
    """One state, held by both packages."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.jc = JBL.make_cascade(cfg)
        self.jn = JBL.make_cascade(cfg.node_view())
        self.jj = JT.make(cfg.junction_cap,
                          (((8,), jnp.int32), ((8,), jnp.uint16)))
        self.js = JT.make(cfg.sink_cap, (((), jnp.int32),))
        self.jp = JSC.make_jspool(cfg)
        self.convert()

    def convert(self):
        """Port state := reference state (the from_numpy converters)."""
        self.tc = CK.cascade_from_numpy(self.jc)
        self.tn = CK.cascade_from_numpy(self.jn)
        self.tj = CK.table_from_numpy(self.jj)
        self.ts = CK.table_from_numpy(self.js)
        self.tp = CK.spool_from_numpy(self.jp)

    def load(self, bases, lens):
        cfg = self.cfg
        self.jc, self.jn, _, jws = _jload(self.jc, self.jn,
                                          jnp.asarray(bases),
                                          jnp.asarray(lens), cfg=cfg)
        self.tc, self.tn, _, tws = TSC.load_batch_nodes_s(
            self.tc, self.tn, torch.from_numpy(bases),
            torch.from_numpy(lens), cfg)
        np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
        return jws, tws

    def scan(self, bases, lens, ws=(None, None)):
        cfg = self.cfg
        jr = _jscan(self.jc, self.jj, self.js, jnp.asarray(bases),
                    jnp.asarray(lens), cfg=cfg, node_cascade=self.jn,
                    window_solid=ws[0], jspool=self.jp)
        tr = TSC.scan_batch(self.tc, self.tj, self.ts,
                            torch.from_numpy(bases),
                            torch.from_numpy(lens), cfg,
                            node_cascade=self.tn, window_solid=ws[1],
                            jspool=self.tp)
        self.jj, self.js, self.jp = jr.junctions, jr.sinks, jr.jspool
        self.tj, self.ts, self.tp = tr.junctions, tr.sinks, tr.jspool
        assert int(tr.n_solid) == int(jr.n_solid)
        assert int(tr.n_junc_pos) == int(jr.n_junc_pos)
        np.testing.assert_array_equal(tr.jm.numpy(), np.asarray(jr.jm))

    def flush(self):
        self.jj, self.jp = _jflush(self.jj, self.jp, cfg=self.cfg)
        self.tj, self.tp = TSC.spool_flush(self.tj, self.tp, self.cfg)

    def check(self):
        _same_cascade(self.tc, self.jc)
        _same_cascade(self.tn, self.jn)
        _same_table(self.tj, self.jj)
        _same_table(self.ts, self.js)
        _same_spool(self.tp, self.jp)


def test_two_pass_tables(reads):
    """Reference loads; both packages scan from the converted state."""
    s = _Both(_cfg())
    batches = _batches(reads, s.cfg)
    for bases, lens in batches:
        s.jc, s.jn, _ = JSC.load_batch_nodes(s.jc, s.jn, jnp.asarray(bases),
                                             jnp.asarray(lens), s.cfg)
    s.convert()
    for bases, lens in batches:
        s.scan(bases, lens)
    s.check()   # spool holds every batch's junction lanes
    s.flush()
    s.check()
    assert int(s.tj.count) > 0 and int(s.ts.count) > 0


@pytest.mark.parametrize("small_spool", [False, True])
def test_stream_tables(reads, monkeypatch, small_spool):
    """Single-pass stream (insert, then scan with the insert pass's window
    solidity). Noisier reads in 1-read batches with a 16-lane cap fill a
    64-lane spool, which then flushes in the middle of the run."""
    if small_spool:
        s = _Both(_cfg(batch_reads=1, scan_update_cap=16))
        reads = _reads(20, 0.02)
    else:
        s = _Both(_cfg())
    flushes = []
    flush = TSC.spool_flush
    monkeypatch.setattr(TSC, "spool_flush",
                        lambda *a: flushes.append(1) or flush(*a))
    for bases, lens in _batches(reads, s.cfg):
        s.scan(bases, lens, ws=s.load(bases, lens))
    s.check()
    assert bool(flushes) == small_spool
    s.flush()
    s.check()


def test_row_runs(rng):
    for P in (1, 7, 40):
        solid = rng.random((16, P)) < 0.7
        junc = solid & (rng.random((16, P)) < 0.3)
        want = JSC._row_runs(jnp.asarray(solid), jnp.asarray(junc))
        got = TSC._row_runs(torch.from_numpy(solid), torch.from_numpy(junc))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cov_dist8_and_upsert_rounds(rng):
    n = 500
    ex, en = rng.integers(0, 8, n), rng.integers(0, 8, n)
    exd, end_ = rng.integers(0, 60, n), rng.integers(0, 60, n)
    exo, eno = rng.random(n) < 0.5, rng.random(n) < 0.5
    want = JSC.cov_dist8(*(jnp.asarray(a) for a in (ex, en, exd, end_,
                                                    exo, eno)))
    got = TSC.cov_dist8(*(torch.from_numpy(a) for a in (ex, en, exd, end_,
                                                        exo, eno)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the compacted rounds visit the live lanes in lane order
    mask = rng.random(n) < 0.3
    seen = []

    def fn(st, cm, ps):
        seen.extend(ps[0][cm].tolist())
        return st + 1

    rounds, total = TSC.upsert_rounds(torch.from_numpy(mask), 32,
                                      (torch.arange(n),), fn, 0)
    assert seen == np.nonzero(mask)[0].tolist()
    assert total == mask.sum() and rounds == -(-total // 32)
