"""The k = 55 path of faucet_tpu_torch (wide codes, ext8 junctions) vs
faucet_tpu.

The same numpy-seeded inputs go through both packages on the CPU: wide
codes and fingerprints (with words whose top bit is set), the ext8 scan's
junction and sink tables slot for slot (code-word columns included, at
k = 55 and with narrow keys at k = 21), a walk round and a resolver step,
the whole pipeline, both CLIs (FASTA/GFA bytes, checkpoints, each
package resuming the other's) and paired ends. Integer data throughout:
every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faucet_tpu import cli as jcli
from faucet_tpu import simulate
from faucet_tpu.config import Config as JConfig
from faucet_tpu.core import bloom as JBL
from faucet_tpu.core import scan as JSC
from faucet_tpu.core import table as JT
from faucet_tpu.core import wide as JW
from faucet_tpu.core.kmer import pack_reads
from faucet_tpu.graph import build as JB
from faucet_tpu.graph import walk as JWK
from faucet_tpu.pipeline import Pipeline as JPipeline
from faucet_tpu_torch import cli as tcli
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.config import Config as TConfig
from faucet_tpu_torch.core import scan as TSC
from faucet_tpu_torch.core import u32x2 as TU
from faucet_tpu_torch.core import wide as TW
from faucet_tpu_torch.graph import walk as TWK
from faucet_tpu_torch.kernels import wide_ext as KW
from faucet_tpu_torch.pipeline import Pipeline as TPipeline

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

K = 55
_jscan = jax.jit(JSC.scan_batch, static_argnames=("cfg",))
_jload = jax.jit(JSC.load_batch, static_argnames=("cfg",))


def _kw(**kw):
    """tests/golden/test_wide_k.py's configuration, in Bloom mode."""
    base = dict(size_kmer=K, max_read_length=120, batch_reads=64,
                estimated_kmers=1 << 14, singletons=1 << 14,
                junction_capacity=1 << 12, sink_capacity=1 << 14,
                fp_rate=0.002)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def wide_case():
    """tests/golden/test_wide_k.py's genome and reads, plus 0.5% errors."""
    rng = np.random.default_rng(808)
    genome = simulate.genome_with_repeats(rng, 2500, n_repeats=2,
                                          repeat_len=220)
    reads = simulate.shred(rng, genome, coverage=40, read_len=120,
                           err_rate=0.005, circular=True)
    return genome, reads


def _stack(words):
    """Reference word tuple -> the port's stacked [4, ...] int64."""
    return np.stack([np.asarray(w) for w in words]).astype(np.int64)


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


@pytest.mark.parametrize("k", [41, 55])
def test_wide_codes_and_fingerprints(rng, k):
    """kmerize_wide (every field), fingerprint and the extension keys
    (kernels/wide_ext.py slot_ext_keys), on reads with N bases and short
    reads; at k = 55 some canonical words have their top bit set (as
    int32 they would be negative)."""
    seqs = ["".join(rng.choice(list("ACGTN" if i % 7 == 0 else "ACGT"),
                               size=int(rng.integers(k - 5, 100))))
            for i in range(40)]
    bases, lens = pack_reads(seqs, 100)
    jv = JW.kmerize_wide(jnp.asarray(bases), jnp.asarray(lens), k)
    tv = TW.kmerize_wide(torch.from_numpy(bases), torch.from_numpy(lens), k)
    for name in ("fwd", "rc", "canon"):
        _eq(getattr(tv, name), _stack(getattr(jv, name)))
    for name in ("canon_is_fwd", "valid", "key_hi", "key_lo"):
        _eq(getattr(tv, name), getattr(jv, name))
    if k == 55:
        assert bool((tv.canon[1:][:, tv.valid] >= 1 << 31).any())
    # fingerprints of random words with every bit pattern
    w = rng.integers(0, 1 << 32, (4, 500), dtype=np.uint64).astype(np.uint32)
    jh, jl = JW.fingerprint(tuple(jnp.asarray(x) for x in w))
    th, tl = TW.fingerprint(torch.from_numpy(w.astype(np.int64)))
    _eq(th, jh)
    _eq(tl, jl)
    jo = JW.wselect(jv.canon_is_fwd, jv.rc, jv.fwd)
    to = TW.wselect(tv.canon_is_fwd, tv.rc, tv.fwd)
    for got, want in zip(KW.slot_ext_keys(tv.canon, to, k),
                         JW.slot_ext_keys_wide(jv.canon, jo, k)):
        _eq(got, want)


def test_host_helpers(rng):
    """The copied host helpers give the reference's values."""
    for k in (33, 55, 63):
        words = np.stack([rng.integers(0, 1 << 32, 200, dtype=np.uint64)
                          .astype(np.uint32) for _ in range(4)], axis=1)
        words[:, 0] &= np.uint32((1 << max(2 * k - 96, 0)) - 1)
        np.testing.assert_array_equal(TW.revcomp_words_np(words, k),
                                      JW.revcomp_words_np(words, k))
        np.testing.assert_array_equal(TW.fingerprint_keys_np(words),
                                      JW.fingerprint_keys_np(words))
        # ACGT strings (window view), short and long, and each with an N
        # (the reference's loop)
        for size in (k - 1, k, k + 7, 3 * k, 300, 70_000):  # > one chunk
            seq = "".join(rng.choice(list("ACGT"), size=size))
            for s in (seq, seq[:size // 2] + "N" + seq[size // 2 + 1:]):
                np.testing.assert_array_equal(
                    TW.encode_windows_wide_np(s, k),
                    JW.encode_windows_wide_np(s, k))
        acgt = [seq[:n] for n in (0, k - 1, k, 40, 2 * k, 300)]
        for many in (acgt, acgt + [s]):
            np.testing.assert_array_equal(
                TW.encode_windows_wide_many_np(many, k),
                np.concatenate([JW.encode_windows_wide_np(x, k)
                                for x in many]))
        km = seq[:k]
        assert TW.encode_kmer_wide(km) == JW.encode_kmer_wide(km)
        assert TW.decode_kmer_wide(TW.encode_kmer_wide(km), k) == km
        for a, b in zip(TW.fingerprint_np(tuple(words.T)),
                        JW.fingerprint_np(tuple(words.T))):
            np.testing.assert_array_equal(a, b)


def _same_table(tt, jt):
    d = CK.table_to_numpy(tt, [np.asarray(v).dtype for v in jt.vals])
    np.testing.assert_array_equal(d["keys_hi"], np.asarray(jt.keys_hi))
    np.testing.assert_array_equal(d["keys_lo"], np.asarray(jt.keys_lo))
    assert len(d["vals"]) == len(jt.vals)
    for g, w in zip(d["vals"], jt.vals):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert int(d["count"]) == int(jt.count)
    assert int(d["dropped"]) == int(jt.dropped)


def _counting(fn, lanes):
    """A membership oracle that records the live lanes of each query."""
    def wrapped(khi, klo, m):
        lanes.append(int(np.asarray(jnp.broadcast_to(m, khi.shape)).sum())
                     if isinstance(khi, jnp.ndarray)
                     else int(m.expand(khi.shape).sum()))
        return fn(khi, klo, m)
    return wrapped


@pytest.mark.parametrize("k", [21, 55])
def test_ext8_scan_tables(wide_case, k):
    """scan_batch with the 8-way extension probe, from one converted
    state: junction and sink tables slot for slot (code words included at
    k = 55; the junction spool at k = 21), and scan_core's probed lanes,
    query by query, equal to the reference's."""
    reads = wide_case[1]
    kw = _kw(size_kmer=k, junction_detect="ext8")
    jcfg, cfg = JConfig(**kw), TConfig(**kw)
    B = cfg.batch_reads
    batches = [pack_reads(reads[i:i + B] + [""] * (B - len(reads[i:i + B])),
                          cfg.max_read_length)
               for i in range(0, len(reads), B)][:4]
    jc = JBL.make_cascade(jcfg)
    for bases, lens in batches:
        jc = _jload(jc, jnp.asarray(bases), jnp.asarray(lens), cfg=jcfg)
    wspec = (((4,), jnp.uint32),) if k > 31 else ()
    jj = JT.make(jcfg.junction_cap,
                 (((8,), jnp.int32), ((8,), jnp.uint16)) + wspec)
    js = JT.make(jcfg.sink_cap, (((), jnp.int32),) + wspec)
    jp = JSC.make_jspool(jcfg) if k <= 31 else None
    tc, tj, ts = (CK.cascade_from_numpy(jc), CK.table_from_numpy(jj),
                  CK.table_from_numpy(js))
    tp = CK.spool_from_numpy(jp) if jp is not None else None
    for bases, lens in batches:
        jr = _jscan(jc, jj, js, jnp.asarray(bases), jnp.asarray(lens),
                    cfg=jcfg, jspool=jp)
        tr = TSC.scan_batch(tc, tj, ts, torch.from_numpy(bases),
                            torch.from_numpy(lens), cfg, jspool=tp)
        jj, js, jp = jr.junctions, jr.sinks, jr.jspool
        tj, ts, tp = tr.junctions, tr.sinks, tr.jspool
        assert int(tr.n_solid) == int(jr.n_solid) > 0
        assert int(tr.n_junc_pos) == int(jr.n_junc_pos)
        _eq(tr.jm, jr.jm)
    if jp is not None:
        jj, jp = JSC.spool_flush(jj, jp, jcfg)
        tj, tp = TSC.spool_flush(tj, tp, cfg)
    _same_table(tj, jj)
    _same_table(ts, js)
    assert int(tj.count) > 0
    # the probed lanes: the window probe, then the [B, P, 8] extension
    # probe with the read-answered slots masked off
    jl, tl = [], []
    bases, lens = batches[0][0][:16], batches[0][1][:16]
    JSC.scan_core(_counting(lambda h, l, m: JBL.cascade_solid(jc, h, l, m,
                                                              jcfg), jl),
                  jnp.asarray(bases), jnp.asarray(lens), jcfg)
    TSC.scan_core(_counting(lambda h, l, m: TSC.BL.cascade_solid(tc, h, l, m,
                                                                 cfg), tl),
                  torch.from_numpy(bases), torch.from_numpy(lens), cfg)
    assert tl == jl and len(tl) == 2 and tl[1] > 0


@pytest.fixture(scope="module")
def wide_state(wide_case):
    """A loaded+scanned reference pipeline at k = 55 (noisy reads, a
    loose filter, so walks meet Bloom-fp branches) and its state
    converted to the port."""
    reads = simulate.shred(np.random.default_rng(55), wide_case[0],
                           coverage=30, read_len=120, err_rate=0.01,
                           circular=True)
    kw = _kw(fp_rate=0.05, bloom_b_log2_override=13)
    jcfg = JConfig(**kw)
    p = JPipeline(jcfg)
    p.load_reads(reads)
    p.scan_reads(reads)
    return ((jcfg, TConfig(**kw)), p, CK.cascade_from_numpy(p.cascade),
            CK.table_from_numpy(p.junctions))


def test_walk_round_wide_and_resolver(wide_state):
    """Walk rounds and resolver steps from every covered junction slot:
    base strips and every frontier field equal the reference's."""
    (jcfg, cfg), p, tc, tj = wide_state
    jt = JB.extract_table(p.junctions)
    rows, slots = np.nonzero(jt["v0"] > 0)
    dirs = (slots >= 4).astype(np.int32)
    forced = np.where(slots < 4, slots, 3 - (slots - 4)).astype(np.int32)
    words = jt["v2"][rows]
    rcw = JW.revcomp_words_np(words, K)
    n = len(rows)
    off = np.zeros(n, bool)
    jfr = JWK.make_frontier_wide(
        tuple(jnp.asarray(words[:, j]) for j in range(4)),
        tuple(jnp.asarray(rcw[:, j]) for j in range(4)), jnp.asarray(dirs),
        jnp.asarray(forced), jnp.ones(n, bool), jnp.asarray(off))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))
    tfr = TWK.make_frontier_wide(t(words.T), t(rcw.T), t(dirs), t(forced),
                                 torch.ones(n, dtype=torch.bool),
                                 torch.from_numpy(off))
    jround = jax.jit(JWK.walk_round_wide, static_argnames=("n_steps", "cfg"))
    jres = jax.jit(JWK.resolve_ambiguous_wide, static_argnames=("cfg",))

    def same(tfr, jfr):
        for name in jfr._fields:
            g, w = getattr(tfr, name), getattr(jfr, name)
            _eq(g, _stack(w) if isinstance(w, tuple) else w)

    judged = 0
    for _ in range(4):
        jfr, jb = jround(p.cascade, p.junctions, jfr, n_steps=24, cfg=jcfg)
        tfr, tb = TWK.walk_round_wide(tc, tj, tfr, 24, cfg)
        _eq(tb, jb)
        same(tfr, jfr)
        judged += int(((tfr.end_kind == TWK.END_AMBIG) & ~tfr.active).sum())
        jfr = jres(p.cascade, jfr, cfg=jcfg)
        tfr = TWK.resolve_ambiguous_wide(tc, tfr, cfg)
        same(tfr, jfr)
    assert judged > 0  # the resolver had ambiguous lanes to judge


def _contigs(g):
    return sorted((g.contigs[i].canonical_seq(), g.contigs[i].cov,
                   g.contigs[i].circular) for i in g.live())


@pytest.mark.parametrize("mode", ["file", "stream"])
def test_pipeline_wide(wide_case, mode, tmp_path):
    """Pipeline at k = 55, two-pass and single-pass (stream_step): the
    contigs, counters, tables (code words included) and FASTA/GFA bytes
    of faucet_tpu."""
    from faucet_tpu.out import fasta as jfa, gfa as jgfa
    from faucet_tpu_torch.out import fasta as tfa, gfa as tgfa

    genome, reads = wide_case
    jp, tp = JPipeline(JConfig(**_kw())), TPipeline(TConfig(**_kw()),
                                                    device="cpu")
    if mode == "file":
        jg, tg = jp.run_file_mode(reads, reads), tp.run_file_mode(reads,
                                                                  reads)
    else:
        jg, tg = jp.run_streaming(reads), tp.run_streaming(reads)
    assert _contigs(tg) == _contigs(jg) and _contigs(tg)
    assert tp.metrics.counters == jp.metrics.counters
    assert tp.node_cascade is None and tp.jspool is None
    _same_table(tp.junctions, jp.junctions)
    _same_table(tp.sinks, jp.sinks)
    for (fa, gfa), g, who in (((jfa, jgfa), jg, "j"), ((tfa, tgfa), tg, "t")):
        fa.write_contigs(g, str(tmp_path / f"{who}.fasta"))
        gfa.write_gfa(g, str(tmp_path / f"{who}.gfa"))
    for ext in ("fasta", "gfa"):
        j = (tmp_path / f"j.{ext}").read_bytes()
        assert j and (tmp_path / f"t.{ext}").read_bytes() == j, ext
    doubled = genome + genome
    for s, _, _ in _contigs(tg):
        assert s in doubled or simulate.revcomp_seq(s) in doubled


def _args(tmp, prefix, *extra):
    return ["-read_load_file", str(tmp / "reads.fa"), "-size_kmer", str(K),
            "-max_read_length", "120", "-estimated_kmers", str(1 << 14),
            "-singletons", str(1 << 14), "--batch_reads", "128",
            "--no_native", "-file_prefix", str(tmp / prefix), *extra]


@pytest.fixture(scope="module")
def cli_runs(wide_case, tmp_path_factory):
    """Both CLIs at k = 55, two-pass, on the same FASTA (single-pass:
    test_pipeline_wide)."""
    tmp = tmp_path_factory.mktemp("cli_wide")
    simulate.write_fasta(str(tmp / "reads.fa"), wide_case[1])
    scan = ["-read_scan_file", str(tmp / "reads.fa")]
    assert jcli.main(_args(tmp, "j_two", *scan)) == 0
    assert tcli.main(_args(tmp, "t_two", *scan, "--device", "cpu")) == 0
    return tmp


def test_cli_wide_byte_identical(cli_runs):
    """FASTA and GFA bytes equal; both checkpoints hold the same arrays
    in the same dtypes (the code words as uint32), no node cascade."""
    tmp, mode = cli_runs, "two"
    for ext in ("fasta", "gfa"):
        j = (tmp / f"j_{mode}.{ext}").read_bytes()
        assert j and (tmp / f"t_{mode}.{ext}").read_bytes() == j, ext
    for ext in ("bloom.npz", "junctions.npz"):
        zj, zt = np.load(tmp / f"j_{mode}.{ext}"), np.load(
            tmp / f"t_{mode}.{ext}")
        assert sorted(zj.files) == sorted(zt.files)
        assert "nd_words" not in zj.files
        for f in zj.files:
            assert zj[f].dtype == zt[f].dtype, f
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)
    z = np.load(tmp / f"t_{mode}.junctions.npz")
    assert z["j_val2"].dtype == np.uint32 and z["s_val1"].shape[1:] == (4,)


@pytest.mark.parametrize("writer", ["j", "t"])
def test_wide_checkpoint_resumes_in_the_other_package(cli_runs, writer):
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


def test_paired_ends_wide():
    """Paired ends at k = 55 through the same scan: pair tables, contigs
    and counters equal the reference's."""
    rng = np.random.default_rng(4242)
    genome = simulate.genome_with_repeats(rng, 1200, n_repeats=8,
                                          repeat_len=80)
    m1, m2 = simulate.shred(rng, genome, coverage=20, read_len=100,
                            circular=True, paired=True, insert=250)
    reads = [x for ab in zip(m1, m2) for x in ab]
    kw = _kw(max_read_length=100, batch_reads=32, paired_ends=True,
             pair_capacity=1 << 12)
    jp, tp = JPipeline(JConfig(**kw)), TPipeline(TConfig(**kw),
                                                 device="cpu")
    for p in (jp, tp):
        p.load_reads(reads)
        p.scan_paired(reads)
    jg, tg = jp.clean_graph(jp.build()), tp.clean_graph(tp.build())
    assert _contigs(tg) == _contigs(jg)
    assert tp.pair_counts() == jp.pair_counts() and tp.pair_counts()
    _same_table(tp.pairs, jp.pairs)
    assert tp.metrics.counters == jp.metrics.counters
