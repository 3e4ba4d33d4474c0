"""Paired ends: faucet_tpu_torch's pair capture, paired pipeline, paired
CLI and pair-table checkpoints vs faucet_tpu's.

The phased-repeat genome is tests/golden/test_pairs.py's: repeat r is
planted twice between four distinct junction families, so mate pairs that
span each copy carry the evidence that phases it. Both packages run it in
Bloom mode (the golden test uses exact mode) and must agree bit for bit:
junction, sink and pair tables (slot arrays included), pair counts,
contigs, and the CLIs' FASTA, GFA and checkpoint bytes. Both must phase
the repeat: the two true splices, no wrong one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faucet_tpu import cli as jcli
from faucet_tpu import simulate
from faucet_tpu.config import Config as JConfig
from faucet_tpu.core import scan as JSC
from faucet_tpu.core import table as JT
from faucet_tpu.core.kmer import revcomp_seq
from faucet_tpu.pipeline import Pipeline as JPipeline
from faucet_tpu_torch import cli as tcli
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.config import Config as TConfig
from faucet_tpu_torch.core import scan as TSC
from faucet_tpu_torch.core import table as TT
from faucet_tpu_torch.core import u32x2 as TU
from faucet_tpu_torch.kernels import compact as KCP
from faucet_tpu_torch.pipeline import Pipeline as TPipeline

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

K = 21


@pytest.fixture(scope="module")
def phased_case():
    """tests/golden/test_pairs.py's phased_case, interleaved."""
    rng = np.random.default_rng(4242)
    g = lambda n: simulate.random_genome(rng, n)
    p, q, s, t, r = g(40), g(40), g(40), g(40), g(40)
    A, B, C, D = g(60), g(60), g(60), g(60)
    M = [g(220) for _ in range(6)]
    genome = (p + A + r + B + q + M[0] + s + C + r + D + t + M[1]
              + p + M[2] + q + M[3] + s + M[4] + t + M[5])
    m1, m2 = simulate.shred(rng, genome, coverage=60, read_len=80,
                            circular=True, paired=True, insert=250)
    interleaved = [x for ab in zip(m1, m2) for x in ab]
    truths = (A + r + B, C + r + D)
    wrongs = (A + r + D, C + r + B)
    return interleaved, truths, wrongs


def _cfg(cls=TConfig, **kw):
    """A Config of either package (the port's by default), from the same
    arguments."""
    base = dict(size_kmer=K, max_read_length=80, batch_reads=128,
                estimated_kmers=1 << 15, singletons=1 << 15,
                junction_capacity=1 << 13, sink_capacity=1 << 14,
                pair_capacity=1 << 14, paired_ends=True)
    base.update(kw)
    return cls(**base)


def _phasing(g, truths, wrongs):
    seqs = []
    for i in g.live():
        c = g.contigs[i]
        s = c.seq + (c.seq[: K - 1] if c.circular else "")
        seqs += [s, revcomp_seq(s)]
    joined = "#".join(seqs)
    return (sum(x in joined for x in truths),
            sum(x in joined for x in wrongs))


def _contigs(g):
    return sorted((g.contigs[i].canonical_seq(), g.contigs[i].cov,
                   g.contigs[i].circular) for i in g.live())


def _same_table(tt, jt):
    d = CK.table_to_numpy(tt, [np.asarray(v).dtype for v in jt.vals])
    np.testing.assert_array_equal(d["keys_hi"], np.asarray(jt.keys_hi))
    np.testing.assert_array_equal(d["keys_lo"], np.asarray(jt.keys_lo))
    for g, w in zip(d["vals"], jt.vals):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert int(d["count"]) == int(jt.count)
    assert int(d["dropped"]) == int(jt.dropped)


# ---- pair capture -----------------------------------------------------------


def test_capture_pairs_matches_reference_above_chunk():
    """tests/golden/test_pairs.py's lossless case: rows with more distinct
    junctions than J_CHUNK (two tiles per side), duplicated codes within a
    row. The pair table equals the reference's slot for slot."""
    rng = np.random.default_rng(7)
    B, P = 3, 120
    nj = JSC.J_CHUNK + 19
    assert TSC.J_CHUNK == JSC.J_CHUNK

    def mk():
        codes = rng.integers(1, 1 << 30, size=(B, P)).astype(np.uint64)
        jm = np.zeros((B, P), bool)
        for r in range(B):
            pos = rng.choice(P, size=nj + 10, replace=False)
            jm[r, pos] = True
            codes[r, pos[nj:]] = codes[r, pos[:10]]
        return (jm, (codes >> np.uint64(32)).astype(np.uint32),
                (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    mates = [mk(), mk()]
    jres = [JSC.ScanResult(None, None, None, None, jnp.asarray(jm),
                           jnp.asarray(hi), jnp.asarray(lo))
            for jm, hi, lo in mates]
    tres = [TSC.ScanResult(None, None, None, None, torch.from_numpy(jm),
                           TU.u32(hi), TU.u32(lo))
            for jm, hi, lo in mates]
    jp = JSC.capture_pairs(JT.make(1 << 15, (((), jnp.int32),)), *jres)
    tp = TSC.capture_pairs(TT.make(1 << 15, (((), torch.int32),)), *tres)
    _same_table(tp, jp)
    assert int(tp.count) == B * nj * nj  # every row's cross product kept
    assert int(tp.vals[0][:tp.capacity].sum()) == B * nj * nj


# ---- kernel branch of upsert_rounds -----------------------------------------


@pytest.mark.parametrize("live", [0.0, 0.12, 1.0, 100, 256, 3 * 256 + 1])
def test_compact_rounds_match_argsort_branch(live):
    """The port's upsert_rounds (one compaction, sliced into rounds; here
    with the plain compaction) folds the same rounds as the reference's
    argsort branch: an order-sensitive fold and a real table upsert agree
    exactly. `live` is a density (0: no round; 1.0: every lane live) or
    a count of live lanes: fewer than K, exactly K, a multiple of K plus
    one."""
    rng = np.random.default_rng(3)
    n, K_ = 8192, 256
    if isinstance(live, float):
        mask_np = rng.random(n) < live
    else:
        mask_np = np.zeros(n, bool)
        mask_np[rng.choice(n, live, replace=False)] = True
    hi_np = rng.integers(0, 1 << 30, n).astype(np.uint32)
    lo_np = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pay_np = rng.integers(0, 1 << 30, n).astype(np.int32)
    total = int(mask_np.sum())
    mask = torch.from_numpy(mask_np)
    tpay = (TU.u32(hi_np), TU.u32(lo_np), torch.from_numpy(pay_np))
    jpay = (jnp.asarray(hi_np), jnp.asarray(lo_np), jnp.asarray(pay_np))

    def tfold(state, cm, ps):
        # order-sensitive, so a difference in lane order would show
        upd = torch.where(cm, ps[2].to(torch.int64) ^ ps[0], 0)
        return (state * 31 + upd.sum()) & 0xFFFFFFFF

    def jfold(state, cm, ps):
        upd = jnp.where(cm, ps[2].astype(jnp.uint32) ^ ps[0], 0)
        return state * 31 + jnp.sum(upd, dtype=jnp.uint32)

    got, t = TSC.upsert_rounds(mask, K_, tpay, tfold,
                               torch.zeros((), dtype=torch.int64))
    want, jt = JSC.upsert_rounds(jnp.asarray(mask_np), K_, jpay, jfold,
                                 jnp.zeros((), jnp.uint32))
    assert t == int(jt) == total
    assert int(got) == int(want)

    def tupsert(tbl, cm, ps):
        return TT.upsert(tbl, ps[0], ps[1], (ps[2],), cm, modes=("add",))

    def jupsert(tbl, cm, ps):
        return JT.upsert(tbl, ps[0], ps[1], (ps[2],), cm, modes=("add",))

    got, _ = TSC.upsert_rounds(mask, K_, tpay, tupsert,
                               TT.make(1 << 14, (((), torch.int32),)))
    want, _ = JSC.upsert_rounds(jnp.asarray(mask_np), K_, jpay, jupsert,
                                JT.make(1 << 14, (((), jnp.int32),)))
    _same_table(got, want)
    assert int(got.count) == total
    # the round loop itself, driven with the plain compaction directly
    again, t = TSC.compact_rounds(mask, K_, tpay, tupsert,
                                  TT.make(1 << 14, (((), torch.int32),)),
                                  KCP.mask_indices_plain)
    assert t == total
    _same_table(again, want)


# ---- the paired pipeline ----------------------------------------------------


@pytest.fixture(scope="module")
def phased_runs(phased_case):
    """Both packages, two-pass paired scan of the phased genome (Bloom
    mode), built and cleaned."""
    reads = phased_case[0]
    out = {}
    for name, p in (("j", JPipeline(_cfg(JConfig))),
                    ("t", TPipeline(_cfg(), device="cpu"))):
        p.load_reads(reads)
        p.scan_paired(reads)
        out[name] = (p, p.clean_graph(p.build()))
    return out


def test_paired_tables_identical(phased_runs):
    (jp, _), (tp, _) = phased_runs["j"], phased_runs["t"]
    for name in ("junctions", "sinks", "pairs"):
        _same_table(getattr(tp, name), getattr(jp, name))
    assert int(tp.pairs.count) > 0


def test_paired_pair_counts_identical(phased_runs):
    (jp, _), (tp, _) = phased_runs["j"], phased_runs["t"]
    assert tp.pair_counts() == jp.pair_counts()
    assert tp.metrics.counters == jp.metrics.counters


def test_paired_contigs_identical_and_phased(phased_case, phased_runs):
    _, truths, wrongs = phased_case
    (jp, jg), (tp, tg) = phased_runs["j"], phased_runs["t"]
    assert _contigs(tg) == _contigs(jg)
    for p, g in ((jp, jg), (tp, tg)):
        assert p.metrics.counters["clean_disentangled"] >= 1
        assert _phasing(g, truths, wrongs) == (2, 0)


def test_paired_streaming_identical(phased_case):
    """Single-pass paired stream (mate batches inserted, then
    pair-scanned): identical contigs and pair counts."""
    reads = phased_case[0]
    jp, tp = JPipeline(_cfg(JConfig)), TPipeline(_cfg(), device="cpu")
    jg, tg = jp.run_streaming(reads), tp.run_streaming(reads)
    assert _contigs(tg) == _contigs(jg)
    assert tp.pair_counts() == jp.pair_counts()
    assert tp.metrics.counters == jp.metrics.counters


def test_pair_table_converters_round_trip(phased_runs):
    """The reference's pair table -> the port's (table_from_numpy) -> the
    reference's layout (table_to_numpy): unchanged."""
    jt = phased_runs["j"][0].pairs
    d = CK.table_to_numpy(CK.table_from_numpy(jt))
    np.testing.assert_array_equal(d["keys_hi"], np.asarray(jt.keys_hi))
    np.testing.assert_array_equal(d["keys_lo"], np.asarray(jt.keys_lo))
    np.testing.assert_array_equal(d["vals"][0], np.asarray(jt.vals[0]))
    assert d["vals"][0].dtype == np.asarray(jt.vals[0]).dtype
    assert int(d["count"]) == int(jt.count)


# ---- the paired CLI ---------------------------------------------------------


def _args(tmp, prefix, *extra):
    return ["-read_load_file", str(tmp / "reads.fa"), "-size_kmer", str(K),
            "-max_read_length", "80", "-estimated_kmers", str(1 << 15),
            "-singletons", str(1 << 15), "--batch_reads", "128",
            "--paired_ends", "--no_native", "-file_prefix",
            str(tmp / prefix), *extra]


@pytest.fixture(scope="module")
def paired_cli_runs(phased_case, tmp_path_factory):
    """Both CLIs with --paired_ends, two-pass and --stream, on the same
    interleaved FASTA. --no_native keeps the test off the native reader
    (its library is rebuilt on first use)."""
    tmp = tmp_path_factory.mktemp("paired_cli")
    simulate.write_fasta(str(tmp / "reads.fa"), phased_case[0])
    scan = ["-read_scan_file", str(tmp / "reads.fa")]
    for name, extra in (("two", scan), ("stream", ["--stream"])):
        assert jcli.main(_args(tmp, f"j_{name}", *extra)) == 0
        assert tcli.main(_args(tmp, f"t_{name}", *extra,
                               "--device", "cpu")) == 0
    return tmp


@pytest.mark.parametrize("mode", ["two", "stream"])
def test_paired_cli_byte_identical(paired_cli_runs, mode):
    tmp = paired_cli_runs
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
    assert "p_keys_hi" in np.load(tmp / f"t_{mode}.junctions.npz").files


@pytest.mark.parametrize("writer", ["j", "t"])
def test_paired_checkpoint_resumes_in_the_other_package(paired_cli_runs,
                                                        writer):
    """A paired checkpoint (pair table included) written by either
    package resumes in the other and emits the same bytes."""
    tmp = paired_cli_runs
    ck = ["-bloom_file", str(tmp / f"{writer}_two.bloom.npz"),
          "-junctions_file", str(tmp / f"{writer}_two.junctions.npz")]
    if writer == "j":
        assert tcli.main(_args(tmp, "resumed_t", *ck, "--device",
                               "cpu")) == 0
        out = "resumed_t"
    else:
        assert jcli.main(_args(tmp, "resumed_j", *ck)) == 0
        out = "resumed_j"
    for ext in ("fasta", "gfa"):
        assert (tmp / f"{out}.{ext}").read_bytes() == \
            (tmp / f"j_two.{ext}").read_bytes()


def test_paired_cli_rejects_odd_batch(paired_cli_runs, capsys):
    tmp = paired_cli_runs
    args = _args(tmp, "odd", "--stream", "--device", "cpu")
    args[args.index("--batch_reads") + 1] = "127"
    assert tcli.main(args) == 2
    assert "even --batch_reads" in capsys.readouterr().err
