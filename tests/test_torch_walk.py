"""faucet_tpu_torch graph walk (graph/walk.py, graph/build.py) vs the
reference, from one converted state: frontiers, base strips, resolver
verdicts and built contig graphs must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faucet_tpu import simulate
from faucet_tpu.config import Config
from faucet_tpu.graph import build as JB
from faucet_tpu.graph import walk as JW
from faucet_tpu.pipeline import Pipeline as JPipeline
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.core import table as TT
from faucet_tpu_torch.core import u32x2 as TU
from faucet_tpu_torch.graph import build as TB
from faucet_tpu_torch.graph import walk as TW

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

K = 21


@pytest.fixture(scope="module")
def state():
    """A loaded+scanned reference pipeline (noisy reads, so walks meet
    Bloom-fp branches) and its state converted to the port."""
    rng = np.random.default_rng(31)
    genome = simulate.genome_with_repeats(rng, 4000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=30, read_len=100,
                           err_rate=0.01, circular=True)
    cfg = Config(size_kmer=K, max_read_length=100, batch_reads=256,
                 estimated_kmers=1 << 12, singletons=1 << 13,
                 junction_capacity=1 << 12, sink_capacity=1 << 14,
                 fp_rate=0.05)
    p = JPipeline(cfg)
    p.load_reads(reads)
    p.scan_reads(reads)
    return (cfg, p, CK.cascade_from_numpy(p.cascade),
            CK.table_from_numpy(p.junctions), CK.table_from_numpy(p.sinks))


def _seeds(p):
    jt = JB.extract_table(p.junctions)
    rows, slots = np.nonzero(jt["v0"] > 0)
    dirs = (slots >= 4).astype(np.int32)
    forced = np.where(slots < 4, slots, 3 - (slots - 4)).astype(np.int32)
    return jt["hi"][rows], jt["lo"][rows], dirs, forced


def _frontiers(hi, lo, dirs, forced, circle_ok):
    n = len(hi)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    from faucet_tpu.core.kmer import revcomp_code_np

    rc = revcomp_code_np(key, K)
    rhi = (rc >> np.uint64(32)).astype(np.uint32)
    rlo = (rc & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    active = np.ones(n, bool)
    jfr = JW.make_frontier(*(jnp.asarray(a) for a in (hi, lo, rhi, rlo,
                                                      dirs, forced, active,
                                                      circle_ok)))
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    tfr = TW.make_frontier(t(hi), t(lo), t(rhi), t(rlo), t(dirs),
                           t(forced), torch.from_numpy(active),
                           torch.from_numpy(circle_ok))
    return jfr, tfr


def _same_frontier(tfr, jfr):
    for name, g, w in zip(jfr._fields, tfr, jfr):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype), err_msg=name)


def test_walk_round_and_resolver(state):
    cfg, p, tc, tj, _ = state
    hi, lo, dirs, forced = _seeds(p)
    jfr, tfr = _frontiers(hi, lo, dirs, forced, np.zeros(len(hi), bool))
    jround = jax.jit(JW.walk_round, static_argnames=("n_steps", "cfg"))
    jres = jax.jit(JW.resolve_ambiguous, static_argnames=("cfg",))
    judged = 0
    for _ in range(6):
        jfr, jb = jround(p.cascade, p.junctions, jfr, n_steps=32, cfg=cfg)
        tfr, tb = TW.walk_round(tc, tj, tfr, 32, cfg)  # table.lookup oracle
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        _same_frontier(tfr, jfr)
        judged += int(((tfr.end_kind == TW.END_AMBIG) & ~tfr.active).sum())
        jfr = jres(p.cascade, jfr, cfg=cfg)
        tfr = TW.resolve_ambiguous(tc, tfr, cfg)
        _same_frontier(tfr, jfr)
    assert judged > 0  # the resolver had ambiguous lanes to judge


def test_sorted_member_matches_lookup(state):
    cfg, p, _, tj, _ = state
    jt = TB.extract_table(tj)
    keys = np.sort((jt["hi"].astype(np.uint64) << np.uint64(32))
                   | jt["lo"]).astype(np.int64)
    rng = np.random.default_rng(4)
    q = np.concatenate([keys, rng.integers(0, 1 << 42, 500)])
    qhi, qlo = TU.u32(q >> 32), TU.u32(q & 0xFFFFFFFF)
    m = torch.from_numpy(rng.random(len(q)) < 0.9)
    got = TW.sorted_member(torch.from_numpy(keys))(qhi, qlo, m)
    want, _ = TT.lookup(tj, qhi, qlo, m)
    assert torch.equal(got, want) and bool(got[: len(keys)].any())


def test_walk_waves_and_build(state):
    cfg, p, tc, tj, ts = state
    hi, lo, dirs, forced = _seeds(p)
    # pass-2 style seeds too: free choice, circles detected
    sk = JB.extract_table(p.sinks)
    n2 = min(200, len(sk["hi"]))
    hi2 = np.concatenate([hi, sk["hi"][:n2]])
    lo2 = np.concatenate([lo, sk["lo"][:n2]])
    dirs2 = np.concatenate([dirs, np.arange(n2) % 2]).astype(np.int32)
    forced2 = np.concatenate([forced, -np.ones(n2, np.int32)])
    circ = np.concatenate([np.zeros(len(hi), bool), np.ones(n2, bool)])
    jfr, tfr = _frontiers(hi2, lo2, dirs2, forced2, circ)
    jfr, jb, jr = JW.walk_waves(p.cascade, p.junctions, jfr, n_rounds=3,
                                n_steps=48, cfg=cfg)
    tfr, tb, tr = TW.walk_waves(tc, tj, tfr, n_rounds=3, n_steps=48,
                                cfg=cfg)
    assert int(jr) == tr
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _same_frontier(tfr, jfr)

    jg = JB.GraphBuilder(cfg, p.cascade, p.junctions, p.sinks).build()
    tg = TB.GraphBuilder(cfg, tc, tj, ts).build()
    end = lambda e: None if e is None else (e.node, e.slot)
    dump = lambda g: [(c.seq, c.cov, end(c.left), end(c.right), c.circular,
                       c.deleted) for c in g.contigs]
    assert dump(tg) == dump(jg)
    assert tg.ports == jg.ports
