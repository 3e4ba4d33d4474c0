"""faucet_tpu_torch kernel modules (probe, cascade, bloom_scatter, compact,
wide_ext, upsert) vs the reference.

On the CPU the wrappers take their plain torch versions; those are held
to the reference's CPU formulation (core/bloom.py) exactly, and to the
Pallas TPU kernels run in interpret mode. Tests marked `cuda` hold the
CUDA kernels to the plain versions on the card; they skip without one.

The reference needs jax, which the GPU machine does not have: jax is
imported inside the `ref` fixture only, so the cuda tests run there with
  python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
(tests/conftest.py imports jax too).
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from faucet_tpu.config import Config as JConfig
from faucet_tpu_torch import metrics as TM
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.config import Config as TConfig
from faucet_tpu_torch.core import bloom as TBL
from faucet_tpu_torch.core import u32x2 as TU
from faucet_tpu_torch.kernels import bloom_scatter as KS
from faucet_tpu_torch.kernels import cascade as KC
from faucet_tpu_torch.kernels import compact as KCP
from faucet_tpu_torch.kernels import probe as KP
from faucet_tpu_torch.kernels import upsert as KU
from faucet_tpu_torch.kernels import wide_ext as KW

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

SENT = 0xFFFFFFFF
JSENT = np.uint32(SENT)


@contextlib.contextmanager
def tallied():
    """The tally of what the block counts outside spans of its own (a
    Pipeline counts into its own Metrics): kernels/build.py counts each
    launch there as `<kernel>_launches`."""
    m = TM.Metrics()
    with m.span("tallied"):
        yield m.tally


def launches(tally, kernel=None):
    """Launches of `kernel` in a tally, or of every kernel."""
    if kernel is not None:
        return tally.get(f"{kernel}_launches", 0)
    return sum(n for k, n in tally.items() if k.endswith("_launches"))


@pytest.fixture(scope="module")
def ref():
    """The reference package's modules (imports jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from faucet_tpu.core import bloom
    from faucet_tpu.kernels import bloom_scatter, compact
    from faucet_tpu.kernels.cascade import cascade_insert_fused
    from faucet_tpu.kernels.probe import bloom_probe_keys

    return types.SimpleNamespace(jnp=jnp, BL=bloom,
                                 fused=cascade_insert_fused,
                                 probe=bloom_probe_keys, scatter=bloom_scatter,
                                 compact=compact)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _keys(rng, n):
    hi = rng.integers(0, 1 << 30, size=n).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def _dup(hi, lo):
    """In-batch duplicates and triples."""
    n = len(hi)
    hi, lo = hi.copy(), lo.copy()
    hi[n // 2:], lo[n // 2:] = hi[: n - n // 2], lo[: n - n // 2]
    hi[-n // 4:], lo[-n // 4:] = hi[: n // 4], lo[: n // 4]
    return hi, lo


@pytest.mark.parametrize("log2_bits,n_keys,n_hash",
                         [(16, 300, 3), (19, 5000, 7), (22, 3000, 3)])
def test_probe_plain_matches_reference(ref, rng, log2_bits, n_keys,
                                       n_hash):
    jnp, JBL = ref.jnp, ref.BL
    jb = JBL.make_bloom(log2_bits)
    ihi, ilo = _keys(rng, n_keys)
    jb = JBL.bloom_insert(jb, jnp.asarray(ihi), jnp.asarray(ilo),
                          jnp.ones(n_keys, bool), n_hash, log2_bits)
    tb = TBL.make_bloom(log2_bits)
    TBL.bloom_insert(tb, TU.u32(ihi), TU.u32(ilo),
                     torch.ones(n_keys, dtype=torch.bool), n_hash, log2_bits)
    np.testing.assert_array_equal(CK.words_to_numpy(tb.words),
                                  np.asarray(jb.words))
    qhi, qlo = _keys(rng, n_keys)
    qhi[: n_keys // 2], qlo[: n_keys // 2] = ihi[: n_keys // 2], \
        ilo[: n_keys // 2]
    qmask = rng.random(n_keys) < 0.8
    want = np.asarray(JBL.bloom_contains(jb, jnp.asarray(qhi),
                                         jnp.asarray(qlo),
                                         jnp.asarray(qmask), n_hash,
                                         log2_bits))
    block, h1r, h2 = JBL._block_h1r_h2(jnp.asarray(qhi), jnp.asarray(qlo),
                                       log2_bits)
    want_k = np.asarray(ref.probe(jb.words, jnp.where(jnp.asarray(qmask),
                                                    block, JSENT),
                                h1r, h2, n_hash, interpret=True))
    np.testing.assert_array_equal(want_k, want)
    with tallied() as tally:
        got = KP.bloom_contains_codes(tb.words, TU.u32(qhi), TU.u32(qlo),
                                      torch.from_numpy(qmask), n_hash,
                                      log2_bits)
    assert launches(tally) == 0  # CPU tensors take the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    got = TBL.bloom_contains(tb, TU.u32(qhi), TU.u32(qlo),
                             torch.from_numpy(qmask), n_hash, log2_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[: n_keys // 2][torch.from_numpy(qmask[: n_keys // 2])].all()


@pytest.mark.parametrize("shape,shard_bits", [((4, 257), 0),
                                              ((2, 3, 50), 2)])
def test_contains_codes_plain_shapes_and_shards(ref, rng, shape, shard_bits):
    """bloom_contains_codes (plain) == the reference's bloom_contains on an
    N-D batch of codes, with the mask broadcast along the leading
    dimensions (the walk's [4, W] frame) and shard bits in the block
    address."""
    jnp, JBL = ref.jnp, ref.BL
    log2_bits, n_hash = 18, 4
    n = int(np.prod(shape))
    hi, lo = _keys(rng, n)
    jb = JBL.bloom_insert(JBL.make_bloom(log2_bits), jnp.asarray(hi),
                          jnp.asarray(lo), jnp.asarray(rng.random(n) < 0.5),
                          n_hash, log2_bits, shard_bits)
    hi, lo = hi.reshape(shape), lo.reshape(shape)
    row_mask = rng.random(shape[-1]) < 0.8
    want = np.asarray(JBL.bloom_contains(
        jb, jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(np.broadcast_to(row_mask, shape)), n_hash, log2_bits,
        shard_bits))
    got = KP.bloom_contains_codes(CK.words_from_numpy(jb.words),
                                  TU.u32(hi), TU.u32(lo),
                                  torch.from_numpy(row_mask), n_hash,
                                  log2_bits, shard_bits)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def _cfgs(la, lb, **kw):
    """The reference's Config and the port's, from the same arguments."""
    kw = dict(size_kmer=31, max_read_length=64, bloom_a_log2_override=la,
              bloom_b_log2_override=lb, **kw)
    return JConfig(**kw), TConfig(**kw)


def _both_insert(ref, jc, tc, hi, lo, mask, cfgs):
    jnp, JBL = ref.jnp, ref.BL
    jc, jnb, jsol = JBL.cascade_insert_nbs(jc, jnp.asarray(hi),
                                           jnp.asarray(lo),
                                           jnp.asarray(mask), cfgs[0])
    tc, tnb, tsol = TBL.cascade_insert_nbs(tc, TU.u32(hi), TU.u32(lo),
                                           torch.from_numpy(mask), cfgs[1])
    np.testing.assert_array_equal(CK.words_to_numpy(tc.a_bloom.words),
                                  np.asarray(jc.a_bloom.words))
    np.testing.assert_array_equal(CK.words_to_numpy(tc.b_bloom.words),
                                  np.asarray(jc.b_bloom.words))
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(tsol.numpy(), np.asarray(jsol))
    return jc, tc


@pytest.mark.parametrize("case", ["dups", "all_masked", "sparse", "nodes"])
def test_cascade_plain_matches_reference(ref, rng, case):
    """Words, new_b and solid identical to the reference's sort+count
    formulation over two batches."""
    cfgs = _cfgs(20, 17)
    n = 3000
    hi, lo = _keys(rng, n)
    mask = rng.random(n) < 0.9
    if case == "dups":
        hi, lo = _dup(hi, lo)
    elif case == "all_masked":
        mask[:] = False
    elif case == "sparse":
        mask = rng.random(n) < 0.03
    else:  # the node cascade's sizes, tagged keys, sparse mask
        cfgs = _cfgs(18, 16, n_hash_a_override=3, n_hash_b_override=3)
        hi = hi | (rng.integers(0, 2, size=n).astype(np.uint32) << 30)
        mask = rng.random(n) < 0.05
    jc = ref.BL.make_cascade(cfgs[0])
    tc = CK.cascade_from_numpy(jc)
    for batch in range(2):
        jc, tc = _both_insert(ref, jc, tc, hi, lo, mask, cfgs)
        hi, lo, mask = hi[::-1].copy(), lo[::-1].copy(), mask[::-1].copy()
    if case == "all_masked":
        assert int(tc.a_bloom.words.abs().sum()) == 0


def _cascade_batch(rng, n, case):
    """Codes and mask of one cascade batch: dense (in-batch duplicates and
    triples), mostly masked, a few hot keys repeated hundreds of times,
    or live lanes whose hi word is 0xFFFFFFFF (dead to the reference)."""
    hi, lo = _dup(*_keys(rng, n))
    mask = rng.random(n) < 0.95
    if case == "mostly_masked":
        mask = rng.random(n) < 0.03
    elif case == "hot_dups":
        pick = rng.integers(0, max(1, n // 500), n)
        hi, lo = hi[pick], lo[pick]
    elif case == "dead_hi":
        hi[::5] = SENT
    return hi, lo, mask


@pytest.mark.parametrize("case,n_shards", [
    ("dense", 1), ("mostly_masked", 1), ("hot_dups", 1), ("dead_hi", 1),
    ("dense", 4)])
def test_cascade_insert_plain_matches_reference(ref, rng, case, n_shards):
    """kernels/cascade.cascade_insert_plain, given the codes, the mask and
    the filter sizes, == the reference's cascade_insert_nbs: filter words,
    new_b and solid, over two batches on the same filters."""
    jnp, JBL = ref.jnp, ref.BL
    jcfg, _ = _cfgs(19, 17, n_hash_a_override=5, n_hash_b_override=3,
                    n_shards=n_shards)
    hi, lo, mask = _cascade_batch(rng, 4000, case)
    jc = JBL.make_cascade(jcfg)
    a = CK.words_from_numpy(jc.a_bloom.words)
    b = CK.words_from_numpy(jc.b_bloom.words)
    flags = []
    for _ in range(2):
        jc, jnb, jsol = JBL.cascade_insert_nbs(
            jc, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(mask), jcfg)
        nb, sol = KC.cascade_insert_plain(
            a, b, TU.u32(hi), TU.u32(lo), torch.from_numpy(mask), 19, 17,
            jcfg.shard_bits, jcfg.n_hash_a, jcfg.n_hash_b)
        np.testing.assert_array_equal(CK.words_to_numpy(a),
                                      np.asarray(jc.a_bloom.words))
        np.testing.assert_array_equal(CK.words_to_numpy(b),
                                      np.asarray(jc.b_bloom.words))
        np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
        np.testing.assert_array_equal(sol.numpy(), np.asarray(jsol))
        flags += [bool(nb.any()), bool(sol.any()), not bool(sol.all())]
        perm = rng.permutation(len(hi))
        hi, lo, mask = hi[perm], lo[perm], mask[perm]
    assert flags[0] and flags[4] and flags[5]  # new_b in the first batch


@pytest.mark.parametrize("la,lb,n,dup", [(18, 16, 500, False),
                                         (20, 17, 2000, True)])
def test_cascade_plain_vs_tpu_kernel(ref, rng, la, lb, n, dup):
    """Against the Pallas kernel (interpret mode): filter words identical,
    new_b key multisets equal, and the kernel's solid flags a superset by
    under 3% (it probes B mid-batch, the formulation pre-batch)."""
    jnp, JBL = ref.jnp, ref.BL
    jcfg, cfg = _cfgs(la, lb)
    hi, lo = _keys(rng, n)
    if dup:
        hi, lo = _dup(hi, lo)
    mask = rng.random(n) < 0.9
    c0 = JBL.make_cascade(jcfg)
    ba, h1r, h2 = JBL._block_h1r_h2(jnp.asarray(hi), jnp.asarray(lo), la)
    bb, _, _ = JBL._block_h1r_h2(jnp.asarray(hi), jnp.asarray(lo), lb)
    ba = jnp.where(jnp.asarray(mask), ba, JSENT)
    aw, bw, nb_k, sol_k = ref.fused(
        c0.a_bloom.words, c0.b_bloom.words, ba, bb, h1r, h2, jcfg.n_hash_a,
        jcfg.n_hash_b, with_solid=True, interpret=True)
    tc = TBL.make_cascade(cfg)
    tc, nb_t, sol_t = TBL.cascade_insert_nbs(tc, TU.u32(hi), TU.u32(lo),
                                             torch.from_numpy(mask), cfg)
    np.testing.assert_array_equal(CK.words_to_numpy(tc.a_bloom.words),
                                  np.asarray(aw))
    np.testing.assert_array_equal(CK.words_to_numpy(tc.b_bloom.words),
                                  np.asarray(bw))

    def multiset(flags):
        f = np.asarray(flags)
        return sorted(zip(hi[f].tolist(), lo[f].tolist()))

    assert multiset(nb_t.numpy()) == multiset(nb_k)
    sk, st = np.asarray(sol_k), sol_t.numpy()
    assert not (st & ~sk).any()
    assert (sk & ~st).mean() < 0.03


def test_wrappers_take_plain_version_on_cpu():
    w = torch.zeros(32, dtype=torch.int32)
    k = torch.zeros(4, dtype=torch.int64)
    # CPU tensors take the plain version and count no launch; the
    # arguments both versions need are checked on both devices
    # (test_entries_refuse_malformed_arguments), the card's own checks on
    # the card (the cuda tests below)
    m = torch.zeros(4, dtype=torch.bool)
    with tallied() as tally:
        assert KP.bloom_contains_codes(w, k, k, ~m, 3, 10).sum() == 0
        new_b, solid = KC.cascade_insert(w.clone(), w.clone(), k, k, m, 10,
                                         10, 0, 3, 3)
        assert not new_b.any() and not solid.any()
        assert int(KS.bloom_insert_codes(w.clone(), k, k, m, 3,
                                         10).abs().sum()) == 0
        assert int(KS.scatter_or_bits(w.clone(), k + SENT).abs().sum()) == 0
        idx, cnt = KCP.mask_indices(torch.zeros(4, dtype=torch.bool), 2)
        assert idx.shape == (2,) and int(cnt) == 0
    assert launches(tally) == 0


def _wide_windows(rng, k, B, L=100, device="cpu"):
    """Wide windows of numpy-made reads with N bases (code 4) and lens
    shorter than L, some shorter than k: the canonical code, the other
    frame (core/scan.py scan_core's `other`) and the view."""
    from faucet_tpu_torch.core import wide as TW

    bases = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.01] = 4
    lens = rng.integers(k - 8, L + 1, size=B).astype(np.int32)
    wv = TW.kmerize_wide(torch.from_numpy(bases).to(device),
                         torch.from_numpy(lens).to(device), k)
    return wv.canon, TW.wselect(wv.canon_is_fwd, wv.rc, wv.fwd), wv


def test_wide_ext_takes_plain_version_on_cpu_and_checks_arguments(rng):
    canon, other, _ = _wide_windows(rng, 55, 16)
    with tallied() as tally:
        got = KW.slot_ext_keys(canon, other, 55)
    want = KW.slot_ext_keys_plain(canon, other, 55)
    assert launches(tally) == 0  # CPU tensors take the plain version
    for g, w in zip(got, want):
        assert g.shape == canon.shape[1:] + (8,) and torch.equal(g, w)
    bad = [(canon.to(torch.int32), other, 55),   # dtype
           (canon, other.to(torch.int32), 55),
           (canon[:3], other[:3], 55),           # not four words
           (canon, other[:, :8], 55),            # shapes differ
           (canon, other, 31), (canon, other, 64)]   # k not wide
    with tallied() as tally:
        for args in bad:
            with pytest.raises(ValueError):
                KW.slot_ext_keys(*args)
    assert launches(tally) == 0


# value arrays of the port's tables: (trailing shape, dtype, mode) of the
# sink (coverage), the junction (cov8, dist8) and the wide code words
SINK_VALS = (((), torch.int32, "add"),)
JUNCTION_VALS = (((8,), torch.int32, "add"), ((8,), torch.int32, "max"))
WORD_VALS = (((4,), torch.int64, "max"),)


def _upsert_case(rng, cap, n, specs, n_keys=None, fill=0, device="cpu"):
    """A table of capacity cap with `fill` keys already upserted, and a
    batch of n lanes (~90% live) over n_keys distinct keys (duplicates
    when n_keys < n), some of them the table's own; values per spec."""
    from faucet_tpu_torch.core import table as TT

    n_keys = n_keys or n
    hi = rng.integers(0, 1 << 30, n_keys + fill).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n_keys + fill,
                      dtype=np.uint64).astype(np.uint32)

    def batch(pick, m):
        vals = tuple(torch.from_numpy(rng.integers(
            0, 1 << 20, (m,) + shape).astype(np.int64)).to(dt)
            for shape, dt, _ in specs)
        return (TU.u32(hi[pick]).to(device), TU.u32(lo[pick]).to(device),
                tuple(v.to(device) for v in vals),
                torch.from_numpy(rng.random(m) < 0.9).to(device))

    tbl = TT.make(cap, tuple((s, d) for s, d, _ in specs), device=device)
    modes = tuple(m for _, _, m in specs)
    if fill:
        khi, klo, vals, mask = batch(np.arange(fill), fill)
        tbl = TT.upsert(tbl, khi, klo, vals, mask, modes)
    # the batch draws from the table's keys and new ones alike
    return tbl, batch(rng.integers(0, n_keys + fill, n), n), modes


def _clone_table(tbl):
    return tbl._replace(keys_hi=tbl.keys_hi.clone(),
                        keys_lo=tbl.keys_lo.clone(),
                        vals=tuple(v.clone() for v in tbl.vals))


def _tables_equal(a, b):
    """Rows [:cap] of every key and value array, count and dropped."""
    cap = a.capacity
    for x, y in zip((a.keys_hi, a.keys_lo) + a.vals,
                    (b.keys_hi, b.keys_lo) + b.vals):
        assert x.dtype == y.dtype and torch.equal(x[:cap], y[:cap])
    assert int(a.count) == int(b.count) and int(a.dropped) == int(b.dropped)


def test_upsert_takes_plain_version_on_cpu_and_checks_arguments(rng):
    """kernels/upsert.probe_rounds on CPU tensors is the sort and combine
    (dedupe) and the torch rounds (probe_rounds_plain), counting no
    launch, on a raw batch and on one already combined; it refuses what
    either version does not take (contiguity is the card's own check: the
    torch rounds take any layout); core/table.py upsert runs in a span
    `upsert` with its probe_round spans inside."""
    from faucet_tpu_torch.core import table as TT

    tbl, (khi, klo, vals, mask), modes = _upsert_case(
        rng, 1 << 10, 600, JUNCTION_VALS + WORD_VALS, n_keys=300, fill=200)
    skhi, sklo, cvals, rep = KU.dedupe(khi, klo, vals, mask, modes)
    with tallied() as tally:
        got = KU.probe_rounds(_clone_table(tbl), skhi, sklo, cvals, rep,
                              modes)
        raw = KU.probe_rounds(_clone_table(tbl), khi, klo, vals, mask, modes)
    want = KU.probe_rounds_plain(_clone_table(tbl), skhi, sklo, cvals, rep,
                                 modes)
    assert launches(tally) == 0
    _tables_equal(got, want)
    _tables_equal(raw, want)
    assert int(got.count) > int(tbl.count)
    c0, c1, c2 = cvals
    _tables_equal(KU.probe_rounds(_clone_table(tbl), skhi, sklo,
                                  (c0, c1.t().contiguous().t(), c2), rep,
                                  modes), want)
    t3 = tbl._replace(vals=tbl.vals[:1] + (tbl.vals[0][:, :3].contiguous(),)
                      + tbl.vals[2:])
    bad = [
        (tbl, skhi, sklo, (c0, c1, c2.to(torch.int32)), rep, modes),  # dtype
        (tbl, skhi.to(torch.int32), sklo, cvals, rep, modes),
        (tbl, skhi, sklo, cvals, rep.to(torch.uint8), modes),
        (t3, skhi, sklo, (c0, c1[:, :3].contiguous(), c2), rep, modes),
        (tbl, skhi, sklo, cvals, rep, ("add", "min", "max")),     # mode
        (tbl, skhi, sklo, (c0, c1.to("meta"), c2), rep, modes),   # device
        (tbl, skhi, sklo, cvals[:2], rep, modes),                 # count
        (tbl._replace(vals=tbl.vals + tbl.vals[:1]), skhi, sklo,
         cvals + cvals[:1], rep, modes + ("add",)),               # four
        (tbl, skhi[:-1], sklo, cvals, rep, modes),                # shape
    ]
    with tallied() as tally:
        for args in bad:
            with pytest.raises(ValueError):
                KU.probe_rounds(*args)
    assert launches(tally) == 0
    m = TM.Metrics()
    with m.span("outer"):
        TT.upsert(_clone_table(tbl), khi, klo, vals, mask, modes)
    assert "outer/upsert" in m.timers
    assert "outer/upsert/probe_round" in m.timers
    assert m.tally["table_probe_rounds"] > 0
    assert "upsert_launches" not in m.tally


# the scan's table updates (kernels/upsert.py upsert_lanes): the tables of
# core/scan.py scan_batch and the scan grid's fields they are built from
LANE_TABLES = {"sink": SINK_VALS, "junction": JUNCTION_VALS,
               "wide_sink": SINK_VALS + WORD_VALS,
               "wide_junction": JUNCTION_VALS + WORD_VALS}


def _collide_keys(n_keys, cap, rng):
    """n_keys distinct keys whose round-0 probe slot in a table of `cap`
    rows is one of four: their probe sequences collide."""
    from faucet_tpu_torch.core.hashing import hash_pair

    hi = rng.integers(0, 1 << 30, 1 << 21).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 1 << 21, dtype=np.uint64).astype(np.uint32)
    h1, _ = hash_pair(TU.u32(hi), TU.u32(lo))
    pick = np.nonzero(((h1 & (cap - 1)) < 4).numpy())[0][:n_keys]
    assert len(pick) == n_keys
    return hi[pick], lo[pick]


def _lane_grid(rng, kind, N, live, n_keys, cap, fill, device="cpu"):
    """A table of `kind` with `fill` keys of the pool already upserted, and
    a flat scan grid of N lanes, `live` of them updates (a few with an
    EMPTY key), their keys drawn from n_keys distinct keys (duplicates
    when fewer than live; "collide": keys of colliding probe sequences),
    as core/scan.py scan_batch hands them to upsert_lanes: key words,
    slot fields, sink coverage and the code words as a strided [N, 4]
    view of [4, N]."""
    from faucet_tpu_torch.core import scan as TSC
    from faucet_tpu_torch.core import table as TT

    specs = LANE_TABLES[kind]
    modes = tuple(m for _, _, m in specs)
    if n_keys == "collide":
        phi, plo = _collide_keys(800, cap, rng)
    else:
        n_pool = (n_keys or max(live, 1)) + fill
        phi = rng.integers(0, 1 << 30, n_pool).astype(np.uint32)
        plo = rng.integers(0, 1 << 32, n_pool,
                           dtype=np.uint64).astype(np.uint32)
    mask = np.zeros(N, bool)
    mask[rng.choice(N, live, replace=False)] = True
    pick = rng.integers(0, len(phi), N)
    hi, lo = phi[pick].copy(), plo[pick]
    hi[rng.random(N) < 0.005] = SENT
    words = rng.integers(0, 1 << 32, (4, N), dtype=np.uint64)
    grid = dict(
        mask=mask, khi=hi.astype(np.int64), klo=lo.astype(np.int64),
        ex_slot=rng.integers(0, 8, N), en_slot=rng.integers(0, 8, N),
        ex_dist=rng.integers(0, 100, N), en_dist=rng.integers(0, 100, N),
        exit_ok=rng.random(N) < 0.6, entry_ok=rng.random(N) < 0.6,
        cov=rng.integers(1, 3, N).astype(np.int32),
        words=words.astype(np.int64))
    g = types.SimpleNamespace(**{k: torch.from_numpy(v).to(device)
                                 for k, v in grid.items()})
    wide = kind.startswith("wide")
    wcol = (g.words.t(),) if wide else ()
    if kind.endswith("junction"):
        g.slots = (g.ex_slot, g.en_slot, g.ex_dist, g.en_dist, g.exit_ok,
                   g.entry_ok)
        g.vals = wcol
    else:
        g.slots, g.vals = None, (g.cov,) + wcol
    g.modes, g.rows = modes, TSC.cov_dist8
    tbl = TT.make(cap, tuple((sh, d) for sh, d, _ in specs), device=device)
    if fill:
        fv = tuple(torch.from_numpy(rng.integers(
            0, 1 << 20, (fill,) + sh).astype(np.int64)).to(d).to(device)
            for sh, d, _ in specs)
        tbl = TT.upsert(tbl, TU.u32(phi[-fill:], device),
                        TU.u32(plo[-fill:], device), fv,
                        torch.ones(fill, dtype=torch.bool, device=device),
                        modes)
    return tbl, g


def _lanes_by_rounds(tbl, g, K, max_rounds=128, shard_bits=0):
    """The scan's table update as it was: core/scan.py upsert_rounds
    (one compaction, K-lane rounds of gathered payloads), the junction
    rows built by cov_dist8, each round a core/table.py upsert."""
    from faucet_tpu_torch.core import scan as TSC
    from faucet_tpu_torch.core import table as TT

    n_rows = 0 if g.slots is None else 6

    def fold(t, cm, ps):
        vals = ps[2 + n_rows:]
        if n_rows:
            vals = tuple(g.rows(*ps[2:8])) + vals
        return TT.upsert(t, ps[0], ps[1], vals, cm, g.modes, max_rounds,
                         shard_bits)

    tbl, _ = TSC.upsert_rounds(g.mask, K, (g.khi, g.klo)
                               + (g.slots or ()) + g.vals, fold, tbl)
    return tbl


def _upsert_lanes(tbl, g, K, max_rounds=128, shard_bits=0):
    idx, cnt = KCP.mask_indices(g.mask, -(-g.mask.shape[0] // K) * K)
    return KU.upsert_lanes(tbl, idx, cnt, K, g.khi, g.klo, g.vals, g.modes,
                           g.slots, g.rows, max_rounds, shard_bits)


@pytest.mark.parametrize("kind", list(LANE_TABLES))
@pytest.mark.parametrize("case", ["duplicates", "dropped"])
def test_upsert_lanes_plain_equals_upsert_rounds(rng, kind, case):
    """On the CPU, upsert_lanes (its plain version: per K-lane chunk the
    gathers, the junction rows, dedupe and the torch rounds) leaves the
    same junction and sink tables, narrow (k = 31) and wide (k = 55), as
    the scan's former round loop (upsert_rounds of core/table.py
    upserts), including probe overflow with duplicates among the dropped
    keys; it tallies the lanes and chunks it took, and no launch."""
    N, live, n_keys, cap, fill, K, rounds = {
        "duplicates": (64 * 70, 1500, 400, 1 << 12, 200, 512, 128),
        "dropped": (64 * 46, 1500, 600, 1 << 8, 100, 512, 4)}[case]
    tbl, g = _lane_grid(rng, kind, N, live, n_keys, cap, fill)
    want = _lanes_by_rounds(_clone_table(tbl), g, K, rounds)
    m = TM.Metrics()
    with m.span("scan"):
        got = _upsert_lanes(_clone_table(tbl), g, K, rounds)
    _tables_equal(got, want)
    assert int(got.count) > int(tbl.count)
    assert (int(got.dropped) > 0) == (case == "dropped")
    assert m.tally["upsert_lanes"] == live
    assert m.tally["upsert_chunks"] == -(-live // K)
    assert launches(m.tally) == 0
    assert "scan/probe_round" in m.timers


def _filter(rng, W):
    """A filter with some bits already set (OR must keep them)."""
    w = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    return w & np.uint32(0x01010101)


@pytest.mark.parametrize("n_hash", [3, 4, 16])
def test_scatter_or_keys_plain_vs_tpu_kernel(ref, rng, n_hash):
    """B5 plain version vs the Pallas kernel (interpret mode, two filter
    tiles, four key chunks): words equal bit for bit; SENTINEL blocks are
    skipped."""
    W, n = 1 << 14, 2048
    words = _filter(rng, W)
    block = rng.integers(0, W // 16, n).astype(np.uint32)
    block[::7] = SENT
    block[1::5] = block[2::5][: len(block[1::5])]  # shared blocks
    h1r = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32) | 1
    jnp = ref.jnp
    want = np.asarray(ref.scatter.scatter_or_keys(
        jnp.asarray(words), jnp.asarray(block), jnp.asarray(h1r),
        jnp.asarray(h2), n_hash, tile_words=W // 2, key_chunk=512,
        interpret=True))
    got = KS.scatter_or_keys_plain(CK.words_from_numpy(words), TU.u32(block),
                                   TU.u32(h1r), TU.u32(h2), n_hash)
    np.testing.assert_array_equal(CK.words_to_numpy(got), want)
    assert (want != words).any()


@pytest.mark.parametrize("shard_bits", [0, 1])
@pytest.mark.parametrize("n_hash", [3, 4, 16])
def test_bloom_insert_codes_plain_matches_reference(ref, rng, shard_bits,
                                                    n_hash):
    """bloom_insert_codes (plain) == the reference's bloom_insert (its CPU
    sort formulation) bit for bit, into a filter with bits already set:
    masked lanes, live codes whose hi word is 0xFFFFFFFF (inserted like
    any other: only the cascade treats them as dead) and duplicate keys."""
    jnp, JBL = ref.jnp, ref.BL
    log2_bits, n = 18, 3000
    words = _filter(rng, 1 << (log2_bits - 5))
    hi, lo = _dup(*_keys(rng, n))
    hi[::7] = SENT
    mask = rng.random(n) < 0.8
    want = np.asarray(JBL.bloom_insert(
        JBL.Bloom(jnp.asarray(words)), jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(mask), n_hash, log2_bits, shard_bits).words)
    with tallied() as tally:
        got = KS.bloom_insert_codes(CK.words_from_numpy(words), TU.u32(hi),
                                    TU.u32(lo), torch.from_numpy(mask),
                                    n_hash, log2_bits, shard_bits)
    assert launches(tally) == 0  # CPU tensors take the plain version
    np.testing.assert_array_equal(CK.words_to_numpy(got), want)
    assert (want != words).any()


def test_scatter_or_bits_plain_vs_tpu_kernel(ref, rng):
    """B6 plain version vs the Pallas kernel (interpret mode, two tiles):
    SENTINEL and out-of-filter positions skipped, duplicates OR once."""
    W, n = 1 << 14, 2048
    words = _filter(rng, W)
    pos = rng.integers(0, W * 32, n).astype(np.uint32)
    pos[::5] = SENT
    pos[1::9] = rng.integers(W * 32, SENT, len(pos[1::9])).astype(np.uint32)
    pos[2::11] = pos[3::11][: len(pos[2::11])]
    jnp = ref.jnp
    want = np.asarray(ref.scatter.scatter_or_bits(
        jnp.asarray(words), jnp.asarray(pos), tile_words=W // 2,
        pos_chunk=512, interpret=True))
    got = KS.scatter_or_bits(CK.words_from_numpy(words), TU.u32(pos))
    np.testing.assert_array_equal(CK.words_to_numpy(got), want)
    assert (want != words).any()


@pytest.mark.parametrize("density,cap", [(0.0, 256), (0.015, 256),
                                         (0.5, 2048), (0.5, 256)])
def test_mask_indices_plain_vs_tpu_kernel(ref, rng, density, cap):
    """B7 plain version vs the Pallas kernel (interpret mode): the first
    min(count, cap) indices and the total count equal; (0.5, 256) has
    count > cap."""
    mask = rng.random(2048) < density
    idx, cnt = ref.compact.mask_indices(ref.jnp.asarray(mask), cap,
                                        interpret=True)
    cnt = int(cnt)
    got, gcnt = KCP.mask_indices(torch.from_numpy(mask), cap)
    assert int(gcnt) == cnt == int(mask.sum())
    m = min(cnt, cap)
    np.testing.assert_array_equal(got.numpy()[:m],
                                  np.asarray(idx)[:m].astype(np.int64))
    assert got.shape == (cap,) and got.dtype == torch.int64


def _entry_args(dev="cpu"):
    """Well-formed arguments of each kernel entry on `dev`: a filter of
    2**10 bits probed with 3 bits, 64 codes, their mask; a table of 2**6
    slots and a batch of its 64 codes; a junction table of 2**6 slots and
    the 64 codes as scan lanes, listed by the compaction, with their slot
    fields; wide windows."""
    from faucet_tpu_torch.core import scan as TSC
    from faucet_tpu_torch.core import table as TT

    g = torch.Generator().manual_seed(5)
    k64 = lambda *shape: torch.randint(0, 1 << 30, shape, generator=g,
                                       dtype=torch.int64).to(dev)
    words = torch.zeros(32, dtype=torch.int32, device=dev)
    mask = (torch.rand(64, generator=g) < 0.5).to(dev)
    tbl = TT.make(1 << 6, (((), torch.int32),), device=dev)
    cv = torch.ones(64, dtype=torch.int32, device=dev)
    jtbl = TT.make(1 << 6, (((8,), torch.int32),) * 2, device=dev)
    slots = tuple(torch.randint(0, 8, (64,), generator=g).to(dev)
                  for _ in range(4)) + (mask, ~mask)
    idx, cnt = KCP.mask_indices(mask, 64)
    return types.SimpleNamespace(
        words=words, khi=k64(64), klo=k64(64), mask=mask, tbl=tbl, cv=cv,
        canon=k64(4, 8, 5), other=k64(4, 8, 5), jtbl=jtbl, slots=slots,
        idx=idx, cnt=cnt, rows=TSC.cov_dist8)


# (entry, what is malformed, the call): each must raise ValueError on
# the CPU as on the card, before either version runs
REFUSALS = (
    ("probe", "filter size", lambda a: KP.bloom_contains_codes(
        a.words, a.khi, a.klo, a.mask, 3, 11)),
    ("probe", "filter dtype", lambda a: KP.bloom_contains_codes(
        a.words.long(), a.khi, a.klo, a.mask, 3, 10)),
    ("probe", "n_hash", lambda a: KP.bloom_contains_codes(
        a.words, a.khi, a.klo, a.mask, 17, 10)),
    ("probe", "shard_bits", lambda a: KP.bloom_contains_codes(
        a.words, a.khi, a.klo, a.mask, 3, 10, 2)),
    ("probe", "code dtype", lambda a: KP.bloom_contains_codes(
        a.words, a.khi.int(), a.klo, a.mask, 3, 10)),
    ("probe", "code shapes", lambda a: KP.bloom_contains_codes(
        a.words, a.khi, a.klo[:-1], a.mask, 3, 10)),
    ("probe", "mask dtype", lambda a: KP.bloom_contains_codes(
        a.words, a.khi, a.klo, a.mask.to(torch.uint8), 3, 10)),
    ("cascade", "filter A size", lambda a: KC.cascade_insert(
        a.words, a.words.clone(), a.khi, a.klo, a.mask, 11, 10, 0, 3, 3)),
    ("cascade", "filter B dtype", lambda a: KC.cascade_insert(
        a.words, a.words.long(), a.khi, a.klo, a.mask, 10, 10, 0, 3, 3)),
    ("cascade", "n_hash", lambda a: KC.cascade_insert(
        a.words, a.words.clone(), a.khi, a.klo, a.mask, 10, 10, 0, 3, 0)),
    ("cascade", "mask shape", lambda a: KC.cascade_insert(
        a.words, a.words.clone(), a.khi, a.klo, a.mask[:-1], 10, 10, 0, 3,
        3)),
    ("cascade", "codes not 1-D", lambda a: KC.cascade_insert(
        a.words, a.words.clone(), a.khi.view(8, 8), a.klo.view(8, 8),
        a.mask.view(8, 8), 10, 10, 0, 3, 3)),
    ("bloom_insert_codes", "filter size", lambda a: KS.bloom_insert_codes(
        a.words, a.khi, a.klo, a.mask, 3, 9)),
    ("bloom_insert_codes", "n_hash", lambda a: KS.bloom_insert_codes(
        a.words, a.khi, a.klo, a.mask, 0, 10)),
    ("bloom_insert_codes", "code dtype", lambda a: KS.bloom_insert_codes(
        a.words, a.khi, a.klo.int(), a.mask, 3, 10)),
    ("bloom_insert_codes", "mask shape", lambda a: KS.bloom_insert_codes(
        a.words, a.khi, a.klo, a.mask[:-1], 3, 10)),
    ("scatter_or_bits", "position dtype", lambda a: KS.scatter_or_bits(
        a.words, a.khi.int())),
    ("scatter_or_bits", "positions not 1-D", lambda a: KS.scatter_or_bits(
        a.words, a.khi.view(8, 8))),
    ("scatter_or_bits", "filter dtype", lambda a: KS.scatter_or_bits(
        a.words.long(), a.khi)),
    ("mask_indices", "mask dtype", lambda a: KCP.mask_indices(
        a.mask.to(torch.uint8), 8)),
    ("mask_indices", "mask not 1-D", lambda a: KCP.mask_indices(
        a.mask.view(8, 8), 8)),
    ("mask_indices", "cap", lambda a: KCP.mask_indices(a.mask, -1)),
    ("slot_ext_keys", "k", lambda a: KW.slot_ext_keys(
        a.canon, a.other, 31)),
    ("slot_ext_keys", "words", lambda a: KW.slot_ext_keys(
        a.canon[:3], a.other[:3], 55)),
    ("slot_ext_keys", "shapes", lambda a: KW.slot_ext_keys(
        a.canon, a.other[:, :4], 55)),
    ("probe_rounds", "mode", lambda a: KU.probe_rounds(
        a.tbl, a.khi, a.klo, (a.cv,), a.mask, ("min",))),
    ("probe_rounds", "value dtype", lambda a: KU.probe_rounds(
        a.tbl, a.khi, a.klo, (a.cv.long(),), a.mask, ("add",))),
    ("probe_rounds", "count dtype", lambda a: KU.probe_rounds(
        a.tbl._replace(count=a.tbl.count.int()), a.khi, a.klo, (a.cv,),
        a.mask, ("add",))),
    ("probe_rounds", "max_rounds", lambda a: KU.probe_rounds(
        a.tbl, a.khi, a.klo, (a.cv,), a.mask, ("add",), -1)),
) + tuple(("upsert_lanes", what, call) for what, call in (
    ("K", lambda a: _lanes_call(a, K=0)),
    ("K not an int", lambda a: _lanes_call(a, K=8.0)),
    ("list shorter than the grid", lambda a: _lanes_call(
        a, idx=a.idx[:32])),
    ("count dtype", lambda a: _lanes_call(a, cnt=a.cnt.int())),
    ("key dtype", lambda a: _lanes_call(a, khi=a.khi.int())),
    ("slot field dtype", lambda a: _lanes_call(
        a, slots=(a.slots[0].int(),) + a.slots[1:])),
    ("flag dtype", lambda a: _lanes_call(
        a, slots=a.slots[:4] + (a.slots[4].long(), a.slots[5]))),
    ("five slot fields", lambda a: _lanes_call(a, slots=a.slots[:5])),
    ("slots without rows", lambda a: _lanes_call(a, rows=None)),
    ("junction rows into a sink table", lambda a: _lanes_call(
        a, tbl=a.tbl._replace(vals=a.tbl.vals * 2))),
    ("junction modes", lambda a: _lanes_call(a, modes=("max", "max"))),
    ("value grid dtype", lambda a: _lanes_call(
        a, tbl=a.tbl, vals=(a.cv.long(),), modes=("add",), slots=None)),
    ("value grid shape", lambda a: _lanes_call(
        a, tbl=a.tbl, vals=(a.cv[:-1],), modes=("add",), slots=None)),
    ("values and modes", lambda a: _lanes_call(
        a, tbl=a.tbl, vals=(a.cv,), modes=("add", "add"), slots=None)),
))


def _lanes_call(a, **kw):
    """upsert_lanes of the junction table over _entry_args' lanes, with
    the keyword arguments given in place of its own."""
    args = dict(tbl=a.jtbl, idx=a.idx, cnt=a.cnt, K=16, khi=a.khi,
                klo=a.klo, vals=(), modes=("add", "max"), slots=a.slots,
                rows=a.rows)
    args.update(kw)
    return KU.upsert_lanes(**args)


@pytest.mark.parametrize("entry,what,call", REFUSALS,
                         ids=[f"{e}-{w}" for e, w, _ in REFUSALS])
def test_entries_refuse_malformed_arguments(entry, what, call):
    """Each kernel entry checks what both of its versions need on both
    devices (kernels/build.py): a malformed argument raises ValueError on
    CPU tensors too, and nothing is counted or written."""
    a = _entry_args()
    before = [t.clone() for t in (a.words, a.tbl.keys_hi)]
    with tallied() as tally:
        with pytest.raises(ValueError):
            call(a)
    assert launches(tally) == 0
    assert all(torch.equal(x, y) for x, y in zip(before,
                                                 (a.words, a.tbl.keys_hi)))


def test_entries_take_well_formed_arguments():
    """The arguments REFUSALS breaks, unbroken, run each entry's plain
    version."""
    a = _entry_args()
    assert KP.bloom_contains_codes(a.words, a.khi, a.klo, a.mask, 3,
                                   10).shape == a.khi.shape
    KC.cascade_insert(a.words, a.words.clone(), a.khi, a.klo, a.mask, 10,
                      10, 0, 3, 3)
    KS.bloom_insert_codes(a.words.clone(), a.khi, a.klo, a.mask, 3, 10)
    KS.scatter_or_bits(a.words.clone(), a.khi)
    assert KCP.mask_indices(a.mask, 8)[0].shape == (8,)
    assert KW.slot_ext_keys(a.canon, a.other, 55)[0].shape == (8, 5, 8)
    t = KU.probe_rounds(a.tbl, a.khi, a.klo, (a.cv,), a.mask, ("add",))
    assert int(t.count) > 0
    a = _entry_args()
    t = _lanes_call(a)
    assert int(t.count) == int(a.cnt) > 0
    t = _lanes_call(a, tbl=a.tbl, vals=(a.cv,), modes=("add",), slots=None)
    assert int(t.count) == int(a.cnt)


# ---- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_hash_a", [4, 7])
def test_kernels_on_card(cuda, n_hash_a):
    """Through core/bloom on the card == on the CPU bit for bit: two dense
    batches with duplicates, then a ~3%-live sparse batch (one cascade
    call each, no probe launch of its own), then a membership query (one
    probe launch)."""
    rng = np.random.default_rng(12345)
    _, cfg = _cfgs(22, 20, n_hash_a_override=n_hash_a, n_hash_b_override=3)
    n = 200_000
    hi, lo = _dup(*_keys(rng, n))
    cg, cp = TBL.make_cascade(cfg, cuda), TBL.make_cascade(cfg)
    for mask in (rng.random(n) < 0.95, rng.random(n) < 0.95,
                 rng.random(n) < 0.03):
        with tallied() as tally:
            _, nb_g, sol_g = TBL.cascade_insert_nbs(
                cg, TU.u32(hi).to(cuda), TU.u32(lo).to(cuda),
                torch.from_numpy(mask).to(cuda), cfg)
        torch.cuda.synchronize()
        assert (launches(tally, "cascade"), launches(tally, "probe")) == \
            (1, 0)
        _, nb_p, sol_p = TBL.cascade_insert_nbs(
            cp, TU.u32(hi), TU.u32(lo), torch.from_numpy(mask), cfg)
        assert torch.equal(cg.a_bloom.words.cpu(), cp.a_bloom.words)
        assert torch.equal(cg.b_bloom.words.cpu(), cp.b_bloom.words)
        assert torch.equal(nb_g.cpu(), nb_p)
        assert torch.equal(sol_g.cpu(), sol_p)
        hi, lo = hi[::-1].copy(), lo[::-1].copy()
    qhi, qlo = _keys(rng, n)
    qmask = rng.random(n) < 0.9
    with tallied() as tally:
        g = TBL.bloom_contains(cg.b_bloom, TU.u32(qhi).to(cuda),
                               TU.u32(qlo).to(cuda),
                               torch.from_numpy(qmask).to(cuda), 3, 20)
    torch.cuda.synchronize()
    assert launches(tally, "probe") == 1
    p = TBL.bloom_contains(cp.b_bloom, TU.u32(qhi), TU.u32(qlo),
                           torch.from_numpy(qmask), 3, 20)
    assert torch.equal(g.cpu(), p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,shard_bits", [(32_768, 0), (573_440, 0),
                                          (100_000, 2)])
def test_contains_codes_on_card(cuda, n, shard_bits):
    """B1 == its plain version on the card, one launch per call, on the
    walk's [4, n] frame with its [n] mask broadcast (no copy)."""
    rng = np.random.default_rng(n + shard_bits)
    words = CK.words_from_numpy(rng.integers(0, 1 << 32, 1 << 20,
                                             dtype=np.uint64), cuda)
    hi, lo = _keys(rng, 4 * n)
    khi, klo = TU.u32(hi, cuda).view(4, n), TU.u32(lo, cuda).view(4, n)
    m = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    with tallied() as tally:
        got = KP.bloom_contains_codes(words, khi, klo, m, 3, 25, shard_bits)
        want = KP.bloom_contains_codes_plain(words, khi, klo, m, 3, 25,
                                             shard_bits)
    torch.cuda.synchronize()
    assert launches(tally) == launches(tally, "probe") == 1
    assert torch.equal(got, want) and bool(want.any()) and \
        not bool(want.all())
    with pytest.raises(ValueError):
        KP.bloom_contains_codes(words, khi.int(), klo, m, 3, 25)
    with pytest.raises(ValueError):
        KP.bloom_contains_codes(words, khi, klo, m, 3, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "mostly_masked", "hot_dups",
                                  "dead_hi"])
def test_cascade_insert_on_card(cuda, case):
    """B2-B4 == cascade_insert_plain bit for bit on the card (filter
    words, new_b, solid) at the load's shape and filter sizes, one wrapper
    launch per call, over two batches; the scratch table is left clean."""
    rng = np.random.default_rng(7)
    n, la, lb = 573_440, 24, 22
    hi, lo, mask = _cascade_batch(rng, n, case)
    a = torch.zeros((1 << (la - 5),), dtype=torch.int32, device=cuda)
    b = torch.zeros((1 << (lb - 5),), dtype=torch.int32, device=cuda)
    ap, bp = a.clone(), b.clone()
    new_b = []
    for _ in range(2):
        args = (TU.u32(hi, cuda), TU.u32(lo, cuda),
                torch.from_numpy(mask).to(cuda), la, lb, 0, 4, 3)
        with tallied() as tally:
            nb, sol = KC.cascade_insert(a, b, *args)
            nbp, solp = KC.cascade_insert_plain(ap, bp, *args)
        torch.cuda.synchronize()
        assert launches(tally, "cascade") == 1
        assert torch.equal(a, ap) and torch.equal(b, bp)
        assert torch.equal(nb, nbp) and torch.equal(sol, solp)
        new_b.append(bool(nb.any()))
        hi, lo, mask = hi[::-1].copy(), lo[::-1].copy(), mask[::-1].copy()
    assert new_b[0] and bool(sol.any())
    assert bool((KC._tables[(a.device, KC.n_slots_for(n))] == -1).all())
    with pytest.raises(ValueError):
        KC.cascade_insert(a, b, *args[:3], la - 1, lb, 0, 4, 3)


@pytest.mark.parametrize("la,lb", [(20, 16), (24, 22), (27, 25), (27, 26),
                                   (28, 22), (28, 25), (29, 25)])
def test_cascade_variant_matches_reference_tiling(ref, la, lb):
    """The variant a launch is counted as is the Pallas kernel the
    reference takes for the same filters: multi-tile exactly where its
    tile is smaller than filter A; a sparse hint takes the sparse one."""
    from faucet_tpu.kernels import cascade as RC

    wa, wb = 1 << (la - 5), 1 << (lb - 5)
    multi = RC._pick_tile_words(wa, wb) < wa
    assert KC.reference_variant(wa, wb, False) == (
        "multi_tile" if multi else "dense")
    assert KC.reference_variant(wa, wb, True) == "sparse"


@pytest.mark.cuda
@pytest.mark.parametrize("la,lb,sparse,variant", [
    (27, 25, False, "dense"), (28, 25, False, "multi_tile"),
    (27, 25, True, "sparse"), (28, 25, True, "sparse")])
def test_cascade_variant_counts_on_card(cuda, la, lb, sparse, variant):
    """Each launch is counted once, under the reference's Pallas variant
    for its call: sparse when flagged, multi-tile when filter A does not
    fit the reference's one tile with B (2**27 bits beside 2**25 fits,
    2**28 does not)."""
    rng = np.random.default_rng(3)
    hi, lo, mask = _cascade_batch(rng, 4096, "dense")
    a = torch.zeros((1 << (la - 5),), dtype=torch.int32, device=cuda)
    b = torch.zeros((1 << (lb - 5),), dtype=torch.int32, device=cuda)
    with tallied() as tally:
        KC.cascade_insert(a, b, TU.u32(hi, cuda), TU.u32(lo, cuda),
                          torch.from_numpy(mask).to(cuda), la, lb, 0, 4, 3,
                          sparse=sparse)
    assert launches(tally, "cascade") == 1
    assert {v: launches(tally, f"cascade_{v}") for v in KC.VARIANTS} == {
        v: int(v == variant) for v in KC.VARIANTS}


@pytest.mark.cuda
@pytest.mark.parametrize("log2_bits,n_hash", [(25, 3), (27, 4)])
def test_scatter_kernels_on_card(cuda, log2_bits, n_hash):
    """B5 (bloom_insert_codes, one launch, hashing in the kernel) and B6 ==
    their plain versions bit for bit on the card, at the 2 Mbp run's
    filter sizes (B 4 MB / A 16 MB), into a filter with bits already set
    and again into the result (every bit already set); bloom_insert on
    CUDA == on the CPU."""
    rng = np.random.default_rng(99)
    W, n = 1 << (log2_bits - 5), 573_440
    words = CK.words_from_numpy(_filter(rng, W), cuda)
    hi, lo = _dup(*_keys(rng, n))
    hi[::11] = SENT
    args = (TU.u32(hi, cuda), TU.u32(lo, cuda),
            torch.from_numpy(rng.random(n) < 0.9).to(cuda), n_hash,
            log2_bits)
    for _ in range(2):
        with tallied() as tally:
            got = KS.bloom_insert_codes(words.clone(), *args)
            want = KS.bloom_insert_codes_plain(words.clone(), *args)
        torch.cuda.synchronize()
        assert launches(tally) == launches(tally, "bloom_insert_codes") == 1
        assert torch.equal(got, want)
        words = got
    pos = TU.u32(rng.integers(0, W * 32, 4 * n), cuda)
    pos[::7] = SENT
    with tallied() as tally:
        got = KS.scatter_or_bits(words.clone(), pos)
        want = KS.scatter_or_bits_plain(words.clone(), pos)
    torch.cuda.synchronize()
    assert launches(tally) == launches(tally, "scatter_or_bits") == 1
    assert torch.equal(got, want)
    bg, bc = TBL.make_bloom(log2_bits, cuda), TBL.make_bloom(log2_bits)
    TBL.bloom_insert(bg, *args)
    TBL.bloom_insert(bc, *(a.cpu() for a in args[:3]), n_hash, log2_bits)
    assert torch.equal(bg.words.cpu(), bc.words)
    with pytest.raises(ValueError):
        KS.bloom_insert_codes(words, args[0].int(), *args[1:])
    with pytest.raises(ValueError):
        KS.bloom_insert_codes(words, *args[:4], log2_bits - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", ["0", "8192", "N"])
@pytest.mark.parametrize("density", [0.0, 0.015, 0.3, 1.0])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 573_440, 1_048_576,
                               4_194_304])
def test_mask_indices_on_card(cuda, n, density, cap):
    """B7 == its plain version on the card, one launch per call: the
    first min(count, cap) indices and the count (above cap, below it, cap
    0 and cap N), at tile edges (4,096 lanes per tile) and on a view that
    starts off the 16-byte grid."""
    cap = n if cap == "N" else int(cap)
    rng = np.random.default_rng(n + int(density * 1000))
    base = torch.from_numpy(rng.random(n + 5) < density).to(cuda)
    for mask in (base[:n], base[5:]):
        with tallied() as tally:
            idx, cnt = KCP.mask_indices(mask, cap)
            pidx, pcnt = KCP.mask_indices_plain(mask, cap)
        torch.cuda.synchronize()
        assert launches(tally) == launches(tally, "compact") == 1
        assert idx.shape == (cap,)
        assert int(cnt) == int(pcnt) == int(mask.sum())
        m = min(int(cnt), cap)
        assert torch.equal(idx[:m], pidx[:m])


@pytest.mark.cuda
def test_mask_indices_back_to_back_on_card(cuda, monkeypatch):
    """200 calls of mixed sizes and alignments, none synchronised, each
    held to its plain version afterwards: the look-back scratch is reused
    by every call and its epoch wraps on the way (so a status word of an
    earlier call never reads as ready)."""
    rng = np.random.default_rng(2024)
    monkeypatch.setattr(KCP, "EPOCH_LIMIT", 64)
    base = torch.from_numpy(rng.random(1_100_000) < 0.2).to(cuda)
    calls = []
    for _ in range(200):
        off = int(rng.integers(0, 32))
        n = int(rng.choice([0, 1, 4095, 4097, 50_000, 573_440, 1_048_576]))
        mask = base[off:off + n]
        calls.append((mask, KCP.mask_indices(mask, n)))
    torch.cuda.synchronize()
    for mask, (idx, cnt) in calls:
        pidx, pcnt = KCP.mask_indices_plain(mask, mask.shape[0])
        assert int(cnt) == int(pcnt)
        assert torch.equal(idx[:int(cnt)], pidx[:int(cnt)])


def _scan_on_both(fn):
    """fn(device) on the CPU (plain compaction) and on the card (kernel),
    counting compaction launches."""
    out = []
    for dev in ("cpu", torch.device("cuda")):
        with tallied() as tally:
            r = fn(dev)
        out.append((r, launches(tally, "compact")))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.03, 0.3])
def test_upsert_rounds_kernel_branch_on_card(cuda, density):
    """upsert_rounds on the card (one compaction launch per call, sliced
    into rounds) folds into the same table as on the CPU (plain
    compaction), over several rounds."""
    from faucet_tpu_torch.core import scan as TSC
    from faucet_tpu_torch.core import table as TT

    rng = np.random.default_rng(5)
    n = 573_440
    mask = torch.from_numpy(rng.random(n) < density)
    hi = TU.u32(rng.integers(0, 1 << 30, n))
    lo = TU.u32(rng.integers(0, 1 << 32, n, dtype=np.uint64))
    val = torch.ones((n,), dtype=torch.int32)

    def fn(tbl, cm, ps):
        return TT.upsert(tbl, ps[0], ps[1], (ps[2],), cm, modes=("add",))

    (a, na), (b, nb) = _scan_on_both(lambda dev: TSC.upsert_rounds(
        mask.to(dev), 8192, tuple(x.to(dev) for x in (hi, lo, val)), fn,
        TT.make(1 << 19, (((), torch.int32),), device=dev)))
    assert (na, nb) == (0, 1) and a[1] == b[1] == int(mask.sum())
    a, b = CK.table_to_numpy(a[0]), CK.table_to_numpy(b[0])
    for f in ("keys_hi", "keys_lo", "count", "dropped"):
        np.testing.assert_array_equal(a[f], b[f])
    np.testing.assert_array_equal(a["vals"][0], b["vals"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_junc", [0, 8192, 16_385])
def test_spool_append_on_card(cuda, n_junc):
    """_spool_append on the card (one compaction launch) == on the CPU:
    the spool's four arrays and its count, after two appends of a
    file-mode batch grid (8,192 x 70 lanes, K 8,192)."""
    from faucet_tpu_torch.core import scan as TSC

    cfg = TConfig(size_kmer=31, max_read_length=100, batch_reads=8192)
    B, P = cfg.batch_reads, cfg.positions_per_read
    rng = np.random.default_rng(n_junc)
    fields = []
    for _ in range(2):
        is_junc = np.zeros(B * P, bool)
        is_junc[rng.choice(B * P, n_junc, replace=False)] = True
        ints = lambda hi: rng.integers(0, hi, (B, P))
        fields.append(dict(
            is_junc=is_junc.reshape(B, P), ex_slot=ints(8), en_slot=ints(8),
            ex_dist=ints(70), en_dist=ints(70),
            exit_ok=rng.random((B, P)) < 0.5,
            entry_ok=rng.random((B, P)) < 0.5, key_hi=ints(1 << 30),
            key_lo=rng.integers(0, 1 << 32, (B, P), dtype=np.int64)))

    def run(dev):
        sp = TSC.make_jspool(cfg, dev)
        for f in fields:
            u = types.SimpleNamespace(**{k: torch.from_numpy(v).to(dev)
                                         for k, v in f.items()})
            _, sp = TSC._spool_append(None, sp, u, cfg)
        return sp

    (a, na), (b, nb) = _scan_on_both(run)
    assert (na, nb) == (0, 2) and a.cnt == b.cnt == 2 * n_junc
    for f in ("khi", "klo", "sf", "dd"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu())


def _b6_case(rng, case, W):
    """Positions for B6's edge cases (int64 holding uint32)."""
    if case == "empty":
        return np.zeros(0, np.int64)
    if case == "all_sentinel":
        return np.full(1000, SENT, np.int64)
    if case == "past_end":   # half past the filter's last bit
        return rng.integers(0, 2 * W * 32, 5000)
    if case == "one_word":   # every position in word 7, many repeats
        return 7 * 32 + rng.integers(0, 32, 100_000)
    p = rng.integers(0, W * 32, 4 * 1024 * 1024)   # "4M"
    p[::9] = SENT
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "all_sentinel", "past_end",
                                  "one_word", "4M"])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_scatter_or_bits_cases_on_card(cuda, case, offset):
    """B6 (one atomicOr per position) == its plain
    version bit for bit: empty input, all SENTINEL, positions past the
    filter's end, every position in one word, 4M positions; each from a
    view starting `offset` positions into its buffer (1 and 3: off the
    16-byte grid)."""
    rng = np.random.default_rng(len(case) * 10 + offset)
    W = 1 << 17
    words = CK.words_from_numpy(_filter(rng, W), cuda)
    buf = TU.u32(np.concatenate([rng.integers(0, W * 32, offset),
                                 _b6_case(rng, case, W)]), cuda)
    pos = buf[offset:]
    with tallied() as tally:
        got = KS.scatter_or_bits(words.clone(), pos)
        want = KS.scatter_or_bits_plain(words.clone(), pos)
    torch.cuda.synchronize()
    assert launches(tally, "scatter_or_bits") == (1 if pos.numel() else 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 47, 48, 49, 55, 63])
def test_wide_ext_on_card(cuda, k):
    """csrc/wide_ext.cu == the plain version bit for bit, all 8 slots:
    word boundaries (k = 47, 48, 49), the top bit at word 0 (k = 63),
    2k = 96 (k = 48); both canonical frames and invalid windows occur. At
    k = 55 the stream cell's 8,192 x 46 windows."""
    rng = np.random.default_rng(1300 + k)
    canon, other, wv = _wide_windows(rng, k, 8192 if k == 55 else 1024,
                                     device=cuda)
    cisf, valid = wv.canon_is_fwd, wv.valid
    assert cisf.any() and (~cisf).any() and valid.any() and (~valid).any()
    with tallied() as tally:
        got = KW.slot_ext_keys(canon, other, k)
    torch.cuda.synchronize()
    assert launches(tally) == launches(tally, "wide_ext") == 1
    want = KW.slot_ext_keys_plain(canon, other, k)
    for g, w in zip(got, want):
        assert g.shape == w.shape == canon.shape[1:] + (8,)
        assert torch.equal(g, w)
    assert torch.equal(got[0], got[0] & 0x3FFFFFFF)
    # the wrapper reads a non-contiguous input as its contiguous copy
    g2 = KW.slot_ext_keys(canon[:, ::2], other[:, ::2], k)
    assert torch.equal(g2[0], want[0][::2]) and torch.equal(g2[1],
                                                             want[1][::2])


@pytest.mark.cuda
def test_wide_pipeline_cpu_equals_cuda(cuda):
    """The k = 55 path (wide codes, ext8 junctions): the Pipeline on the
    CPU (plain versions) and on the card (kernels) gives the same contigs
    and the same junction and sink tables, code-word columns included."""
    from faucet_tpu_torch import simulate
    from faucet_tpu_torch.pipeline import Pipeline

    rng = np.random.default_rng(808)
    genome = simulate.genome_with_repeats(rng, 2500, n_repeats=2,
                                          repeat_len=220)
    reads = simulate.shred(rng, genome, coverage=40, read_len=120,
                           err_rate=0.005, circular=True)
    cfg = TConfig(size_kmer=55, max_read_length=120, batch_reads=64,
                  estimated_kmers=1 << 14, singletons=1 << 14,
                  junction_capacity=1 << 12, sink_capacity=1 << 14,
                  fp_rate=0.002)
    out = []
    for dev in ("cpu", cuda):
        p = Pipeline(cfg, device=dev)
        g = p.run_file_mode(reads, reads)
        out.append((sorted(g.contigs[i].canonical_seq() for i in g.live()),
                    [CK.table_to_numpy(t) for t in (p.junctions, p.sinks)]))
    (ca, ta), (cb, tb) = out
    assert ca == cb and ca
    for x, y in zip(ta, tb):
        for f in ("keys_hi", "keys_lo", "count", "dropped"):
            np.testing.assert_array_equal(x[f], y[f])
        assert len(x["vals"]) == len(y["vals"]) and x["vals"][-1].dtype == \
            np.uint32
        for u, v in zip(x["vals"], y["vals"]):
            np.testing.assert_array_equal(u, v)


# (name, capacity, lanes, value specs, distinct keys, keys already in
# the table, shard_bits, max_rounds)
UPSERT_CASES = (
    ("sink", 1 << 16, 8192, SINK_VALS, None, 0, 0, 128),
    ("junction", 1 << 15, 8192, JUNCTION_VALS, None, 0, 0, 128),
    ("wide", 1 << 15, 8192, JUNCTION_VALS + WORD_VALS, None, 0, 0, 128),
    ("shard_bits_2", 1 << 15, 8192, SINK_VALS + WORD_VALS, None, 0, 2, 128),
    ("prefilled", 1 << 14, 8192, JUNCTION_VALS, 6000, 6000, 0, 128),
    ("duplicates", 1 << 14, 8192, JUNCTION_VALS + WORD_VALS, 500, 0, 0, 128),
    ("overflow", 1 << 8, 600, SINK_VALS, None, 200, 0, 4),
    ("empty_batch", 1 << 10, 0, JUNCTION_VALS, None, 300, 0, 128),
    ("one_lane", 1 << 10, 1, SINK_VALS, None, 300, 0, 128),
    ("no_values", 1 << 14, 8192, (), 5000, 2000, 0, 128),
    ("grid", 1 << 21, 573_440, SINK_VALS + WORD_VALS, 400_000, 200_000, 0,
     128),
    ("grid_shards", 1 << 20, 65_536, JUNCTION_VALS, 30_000, 20_000, 2, 128),
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", UPSERT_CASES, ids=lambda c: c[0])
def test_upsert_kernel_on_card(cuda, case):
    """csrc/table_upsert.cu == the torch rounds on the card, bit for bit:
    rows [:cap] of the keys and every value array, count and dropped; one
    launch a call. Narrow sink, junction, wide words, sharded slots, a
    pre-filled table (matches and claims in one round), heavy duplicates,
    probe overflow (dropped > 0), 0 and 1 lanes, no values, one block
    (8,192 lanes) and the cooperative grid (573,440 and 65,536)."""
    from faucet_tpu_torch.core import table as TT

    name, cap, n, specs, n_keys, fill, sb, rounds = case
    rng = np.random.default_rng(1500 + len(name) + n)
    tbl, (khi, klo, vals, mask), modes = _upsert_case(
        rng, cap, n, specs, n_keys=n_keys, fill=fill, device=cuda)
    skhi, sklo, cvals, rep = KU.dedupe(khi, klo, vals, mask, modes)
    want = KU.probe_rounds_plain(_clone_table(tbl), skhi, sklo, cvals, rep,
                                 modes, rounds, sb)
    with tallied() as tally:
        got = KU.probe_rounds(_clone_table(tbl), skhi, sklo, cvals,
                              rep.clone(), modes, rounds, sb)
    torch.cuda.synchronize()
    assert launches(tally) == launches(tally, "upsert") == 1
    _tables_equal(got, want)
    assert int(want.count) > int(tbl.count) or n < 600
    assert (int(want.dropped) > int(tbl.dropped)) == (name == "overflow")
    # twice over: the second call only matches (nothing new, values grow)
    again = KU.probe_rounds(got, skhi, sklo, cvals, rep.clone(), modes,
                            rounds, sb)
    want2 = KU.probe_rounds_plain(want, skhi, sklo, cvals, rep, modes,
                                  rounds, sb)
    torch.cuda.synchronize()
    _tables_equal(again, want2)


@pytest.mark.cuda
def test_upsert_one_launch_and_no_rounds_on_card(cuda):
    """On the card core/table.py upsert is one kernel launch, counted in
    upsert_launches, inside its span `upsert`: no probe_round span, no
    host read."""
    from faucet_tpu_torch.core import table as TT

    rng = np.random.default_rng(15)
    tbl, (khi, klo, vals, mask), modes = _upsert_case(
        rng, 1 << 14, 8192, JUNCTION_VALS, device=cuda)
    m = TM.Metrics()
    with m.span("outer"):
        for _ in range(3):
            tbl = TT.upsert(tbl, khi, klo, vals, mask, modes)
    torch.cuda.synchronize()
    assert launches(m.tally) == m.tally["upsert_launches"] == 3
    assert "outer/upsert" in m.timers
    assert not any(k.endswith("probe_round") for k in m.timers)
    assert "table_probe_rounds" not in m.tally
    assert "host_syncs" not in m.tally


# (name, table, grid lanes N, live lanes, distinct keys, capacity, keys
# already held, shard_bits, K, max_rounds)
LANES_CASES = (
    ("junction_dups", "junction", 8192 * 70, 20_000, 2_000, 1 << 15, 0, 0,
     8192, 128),
    ("wide_junction", "wide_junction", 8192 * 46, 12_000, 9_000, 1 << 15,
     3_000, 0, 8192, 128),
    ("sink_two_chunks", "sink", 8192 * 70, 16_384, None, 1 << 16, 5_000, 0,
     8192, 128),
    ("wide_sink_one_chunk", "wide_sink", 8192 * 46, 8192, 6_000, 1 << 16,
     0, 0, 8192, 128),
    ("no_lanes", "junction", 8192 * 70, 0, None, 1 << 12, 500, 0, 8192,
     128),
    ("collide", "sink", 65_536, 6_000, "collide", 1 << 12, 0, 0, 4096, 128),
    ("dropped", "wide_junction", 4_096, 1_500, 600, 1 << 8, 100, 0, 512, 4),
    ("shards", "wide_junction", 65_536, 20_000, 8_000, 1 << 15, 2_000, 2,
     8192, 128),
    ("chunks_past_the_grid", "sink", 1 << 20, 700_000, 500_000, 1 << 21, 0,
     0, 1 << 19, 128),
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LANES_CASES, ids=lambda c: c[0])
def test_upsert_lanes_on_card(cuda, case):
    """upsert_lanes on the card (one launch: the listed lanes unsorted,
    duplicates combined on the table, every chunk) == its plain version
    on the CPU, bit for bit: rows [:cap] of the keys and every value
    array, count and dropped, and the lanes and chunks it tallies. Heavy
    duplicates, colliding probe sequences, 0 lanes, exactly K, 2K and a
    count that is not a multiple of K, narrow and wide junction and sink
    tables, overflow with duplicates among the dropped keys, shard_bits
    2, and chunks wider than the threads the card holds at once. Twice
    over: the second pass only matches."""
    name, kind, N, live, n_keys, cap, fill, sb, K, rounds = case
    rng = np.random.default_rng(1800 + len(name) + live)
    tbl, g = _lane_grid(rng, kind, N, live, n_keys, cap, fill)
    tbl_c, g_c = _lane_grid(np.random.default_rng(1800 + len(name) + live),
                            kind, N, live, n_keys, cap, fill, device=cuda)
    want = _upsert_lanes(_clone_table(tbl), g, K, rounds, sb)
    m = TM.Metrics()
    with m.span("scan"):
        got = _upsert_lanes(_clone_table(tbl_c), g_c, K, rounds, sb)
        assert "host_syncs" not in m.tally
        again = _upsert_lanes(got, g_c, K, rounds, sb)
    want2 = _upsert_lanes(want, g, K, rounds, sb)
    torch.cuda.synchronize()
    assert launches(m.tally, "upsert") == 2
    assert launches(m.tally) == launches(m.tally, "compact") + 2
    cpu = lambda t: t._replace(keys_hi=t.keys_hi.cpu(),
                               keys_lo=t.keys_lo.cpu(),
                               vals=tuple(v.cpu() for v in t.vals))
    _tables_equal(cpu(got), want)
    _tables_equal(cpu(again), want2)
    m.counters
    assert m.tally["upsert_lanes"] == 2 * live
    assert m.tally["upsert_chunks"] == 2 * -(-live // K)
    assert (int(want.count) > int(tbl.count)) == (live > 0)
    assert (int(want.dropped) > 0) == (name == "dropped")


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_keys,cap,rounds", [
    (8192, 1_000, 1 << 14, 128), (573_440, 100_000, 1 << 19, 128),
    (2_000, 700, 1 << 8, 3)], ids=["block", "grid", "dropped"])
def test_upsert_unsorted_duplicates_on_card(cuda, n, n_keys, cap, rounds):
    """core/table.py upsert on the card, given an unsorted batch with
    duplicate keys, == the sorted path (dedupe, then the torch rounds) on
    the card: rows [:cap], count and dropped; one launch, no sort."""
    from faucet_tpu_torch.core import table as TT

    rng = np.random.default_rng(18 + n)
    tbl, (khi, klo, vals, mask), modes = _upsert_case(
        rng, cap, n, JUNCTION_VALS + WORD_VALS, n_keys=n_keys,
        fill=n_keys // 4, device=cuda)
    want = KU.probe_rounds_plain(
        _clone_table(tbl), *KU.dedupe(khi, klo, vals, mask, modes), modes,
        rounds)
    sorts = []
    orig = torch.sort
    with tallied() as tally:
        torch.sort = lambda *a, **kw: sorts.append(1) or orig(*a, **kw)
        try:
            got = TT.upsert(_clone_table(tbl), khi, klo, vals, mask, modes,
                            rounds)
        finally:
            torch.sort = orig
    torch.cuda.synchronize()
    assert launches(tally) == launches(tally, "upsert") == 1 and not sorts
    _tables_equal(got, want)
    assert (int(want.dropped) > 0) == (rounds < 128)


@pytest.mark.cuda
@pytest.mark.parametrize("what,call", [(w, c) for e, w, c in REFUSALS
                                       if e == "upsert_lanes"],
                         ids=[w for e, w, _ in REFUSALS
                              if e == "upsert_lanes"])
def test_upsert_lanes_refuses_on_card(cuda, what, call):
    """upsert_lanes refuses on the card what it refuses on the CPU
    (ValueError), before a launch."""
    a = _entry_args(cuda)
    with tallied() as tally:
        with pytest.raises(ValueError):
            call(a)
    torch.cuda.synchronize()
    assert launches(tally) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 55])
def test_stream_batch_one_upsert_launch_a_table_on_card(cuda, k):
    """A single-shard stream batch on the card makes one upsert launch
    per table it updates (k = 55: junctions and sinks; k = 31: sinks,
    the junctions going to the spool) and no torch.sort (no spool flush
    falls in these batches); it tallies the lanes and chunks that the
    CPU's plain version tallies."""
    from faucet_tpu_torch import simulate
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    rng = np.random.default_rng(1831 + k)
    genome = simulate.genome_with_repeats(rng, 20_000, n_repeats=3,
                                          repeat_len=300)
    reads = simulate.shred(rng, genome, coverage=30, read_len=100,
                           err_rate=0.005, circular=True)
    cfg = TConfig(size_kmer=k, max_read_length=100, batch_reads=4096,
                  estimated_kmers=1 << 16, singletons=1 << 17,
                  junction_capacity=1 << 14, sink_capacity=1 << 16,
                  fp_rate=0.002)
    batches = list(batch_iter(reads, cfg))
    assert len(batches) >= 2
    tallies = []
    for dev in ("cpu", cuda):
        p = Pipeline(cfg, device=dev)
        sorts = []
        orig = torch.sort

        def sort(*a, **kw):
            sorts.append(TM._stack()[-1].path)
            return orig(*a, **kw)

        torch.sort = sort
        try:
            for bases, lens in batches:
                p.stream_step(bases, lens)
        finally:
            torch.sort = orig
        p.metrics.counters
        tallies.append(dict(p.metrics.tally))
    tally = tallies[1]
    assert "spool_flushes" not in tally
    assert tally["upsert_launches"] == (2 if k > 31 else 1) * len(batches)
    assert sorts == []
    for key in ("upsert_lanes", "upsert_chunks"):
        assert tally[key] == tallies[0][key] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 55])
def test_stream_step_cpu_equals_cuda(cuda, k):
    """Pipeline.stream_step over whole batches on the CPU (torch rounds)
    and on the card (the upsert kernel) leaves the same junction and sink
    tables; at k = 31 the junction spool's flush too."""
    from faucet_tpu_torch import simulate
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    rng = np.random.default_rng(1531 + k)
    genome = simulate.genome_with_repeats(rng, 20_000, n_repeats=3,
                                          repeat_len=300)
    reads = simulate.shred(rng, genome, coverage=30, read_len=100,
                           err_rate=0.005, circular=True)
    cfg = TConfig(size_kmer=k, max_read_length=100, batch_reads=4096,
                  estimated_kmers=1 << 16, singletons=1 << 17,
                  junction_capacity=1 << 14, sink_capacity=1 << 16,
                  fp_rate=0.002)
    batches = list(batch_iter(reads, cfg))
    assert len(batches) >= 2
    out = []
    for dev in ("cpu", cuda):
        p = Pipeline(cfg, device=dev)
        with tallied() as tally:
            for bases, lens in batches:
                p.stream_step(bases, lens)
            p.flush_junctions()
        if dev != "cpu":
            torch.cuda.synchronize()
        out.append(([CK.table_to_numpy(t) for t in (p.junctions, p.sinks)],
                    launches(tally, "upsert")
                    + launches(p.metrics.tally, "upsert")))
    (ta, na), (tb, nb) = out
    assert na == 0 and nb >= len(batches)
    for x, y in zip(ta, tb):
        assert int(x["count"]) > 0
        for f in ("keys_hi", "keys_lo", "count", "dropped"):
            np.testing.assert_array_equal(x[f], y[f])
        for u, v in zip(x["vals"], y["vals"]):
            np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("k,kw", [(21, dict(exact=True)),
                                  (55, dict(exact=True)),
                                  (21, dict(prune_slot_cov=2))])
def test_exact_and_prune_cpu_equals_cuda(cuda, k, kw):
    """Exact mode (tables for A and B, and D and E at k = 21) and the
    prune_slots pre-clean: the Pipeline on the CPU and on the card gives
    the same contigs and the same tables, cascade tables included. The
    exact path launches the compaction kernel and no probe or cascade
    kernel."""
    from faucet_tpu_torch import simulate
    from faucet_tpu_torch.pipeline import Pipeline

    rng = np.random.default_rng(777)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    reads = simulate.shred(rng, genome, coverage=40, read_len=100,
                           err_rate=0.005, circular=True)
    cfg = TConfig(size_kmer=k, max_read_length=100, batch_reads=64,
                  estimated_kmers=1 << 14, singletons=1 << 14,
                  junction_capacity=1 << 13, sink_capacity=1 << 14,
                  fp_rate=0.002, **kw)
    out = []
    for dev in ("cpu", cuda):
        p = Pipeline(cfg, device=dev)
        with tallied() as tally:
            g = p.run_file_mode(reads, reads)
        torch.cuda.synchronize()
        n = [launches(tally, x) + launches(p.metrics.tally, x)
             for x in ("probe", "cascade", "compact")]
        tables = [p.junctions, p.sinks]
        if cfg.exact:
            tables += [p.cascade.a_table, p.cascade.b_table]
            if p.node_cascade is not None:
                tables += [p.node_cascade.a_table, p.node_cascade.b_table]
        out.append((sorted(g.contigs[i].canonical_seq() for i in g.live()),
                    [CK.table_to_numpy(t) for t in tables], n))
    (ca, ta, na), (cb, tb, nb) = out
    assert ca == cb and ca
    assert na == [0, 0, 0] and nb[2] > 0
    assert (nb[0] == 0 and nb[1] == 0) == cfg.exact
    for x, y in zip(ta, tb):
        for f in ("keys_hi", "keys_lo", "count", "dropped"):
            np.testing.assert_array_equal(x[f], y[f])
        for u, v in zip(x["vals"], y["vals"]):
            np.testing.assert_array_equal(u, v)


# (entry, what only the card refuses, the call on CUDA arguments)
CARD_REFUSALS = (
    ("probe", "filter off the 16-byte grid",
     lambda a: KP.bloom_contains_codes(
         torch.zeros(36, dtype=torch.int32, device=a.words.device)[1:33],
         a.khi, a.klo, a.mask, 3, 10)),
    ("probe", "codes on the CPU", lambda a: KP.bloom_contains_codes(
        a.words, a.khi.cpu(), a.klo.cpu(), a.mask, 3, 10)),
    ("cascade", "codes not contiguous", lambda a: KC.cascade_insert(
        a.words, a.words.clone(), a.khi[::2], a.klo[::2], a.mask[::2], 10,
        10, 0, 3, 3)),
    ("bloom_insert_codes", "filter off the 16-byte grid",
     lambda a: KS.bloom_insert_codes(
         torch.zeros(36, dtype=torch.int32, device=a.words.device)[2:34],
         a.khi, a.klo, a.mask, 3, 10)),
    ("scatter_or_bits", "positions not contiguous",
     lambda a: KS.scatter_or_bits(a.words, a.khi[::2])),
    ("mask_indices", "mask not contiguous", lambda a: KCP.mask_indices(
        a.mask[::2], 8)),
    ("probe_rounds", "values not contiguous", lambda a: KU.probe_rounds(
        a.tbl._replace(vals=(torch.zeros((65, 2), dtype=torch.int32,
                                         device=a.cv.device)[:, 0],)),
        a.khi, a.klo, (a.cv,), a.mask, ("add",))),
)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,what,call", CARD_REFUSALS,
                         ids=[f"{e}-{w}" for e, w, _ in CARD_REFUSALS])
def test_entries_refuse_on_card(cuda, entry, what, call):
    """What only the card needs (kernels/build.py on_card: one CUDA
    device, contiguity, a 16-byte aligned filter) is refused before a
    launch, and nothing is counted."""
    a = _entry_args(cuda)
    with tallied() as tally:
        with pytest.raises(ValueError):
            call(a)
    torch.cuda.synchronize()
    assert launches(tally) == 0
