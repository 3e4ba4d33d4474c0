"""faucet_tpu_torch core modules vs the faucet_tpu reference on the CPU.

The same numpy inputs, made from a seed, go through both packages; every
result is integer, so the tolerance is exact equality throughout.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from faucet_tpu.core import bloom as JBL
from faucet_tpu.core import hashing as JH
from faucet_tpu.core import kmer as JK
from faucet_tpu.core import nodes as JND
from faucet_tpu.core import slots as JS
from faucet_tpu.core import table as JT
from faucet_tpu.core import u32x2 as JU
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.core import hashing as TH
from faucet_tpu_torch.core import kmer as TK
from faucet_tpu_torch.core import nodes as TND
from faucet_tpu_torch.core import slots as TS
from faucet_tpu_torch.core import table as TT
from faucet_tpu_torch.core import u32x2 as TU
from faucet_tpu_torch.kernels import probe as KP

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)


def t(a):
    """numpy uint32 words -> the port's int64 words."""
    return TU.u32(a)


def same(got, want):
    """Port tensor (uint32-valued or bool or small int) == reference."""
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    if w.dtype == np.uint32:
        g = np.asarray(g).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(g).astype(w.dtype), w)


def _words(rng, n, bits=32):
    return rng.integers(0, 1 << bits, size=n, dtype=np.uint64).astype(
        np.uint32)


def test_u32_helpers(rng):
    n = 4096
    ah, al, bh, bl = (_words(rng, n) for _ in range(4))
    bh[: n // 4] = ah[: n // 4]  # equal high words exercise the lo tie
    bl[: n // 8] = al[: n // 8]
    b2 = rng.integers(0, 4, size=n).astype(np.uint32)
    J = lambda *a: tuple(jnp.asarray(x) for x in a)
    for jf, tf in ((JU.shl2, TU.shl2), (JU.shr2, TU.shr2)):
        for g, w in zip(tf(t(ah), t(al)), jf(*J(ah, al))):
            same(g, w)
    for bitpos in (0, 30, 32, 58):
        for g, w in zip(TU.or_base_at(t(ah), t(al), t(b2), bitpos),
                        JU.or_base_at(*J(ah, al, b2), bitpos)):
            same(g, w)
    for nbits in (10, 32, 42, 62, 64):
        for g, w in zip(TU.mask_bits(t(ah), t(al), nbits),
                        JU.mask_bits(*J(ah, al), nbits)):
            same(g, w)
    for jf, tf in ((JU.eq, TU.eq), (JU.lt, TU.lt), (JU.le, TU.le)):
        same(tf(t(ah), t(al), t(bh), t(bl)), jf(*J(ah, al, bh, bl)))
    for g, w in zip(TU.min_pair(t(ah), t(al), t(bh), t(bl)),
                    JU.min_pair(*J(ah, al, bh, bl))):
        same(g, w)
    # int32 storage round trip and the sign-order trap
    same(TU.from_i32(TU.to_i32(t(ah))), ah)
    keys = TU.sort_key(t(ah), t(al))
    order = torch.sort(keys, stable=True).indices.numpy()
    want = np.lexsort((al, ah))
    np.testing.assert_array_equal(order, want)


def test_hashing(rng):
    n = 5000
    hi, lo, h2, l2 = (_words(rng, n) for _ in range(4))
    same(TH.fmix32(t(hi)), JH.fmix32(jnp.asarray(hi)))
    for g, w in zip(TH.hash_pair(t(hi), t(lo)),
                    JH.hash_pair(jnp.asarray(hi), jnp.asarray(lo))):
        same(g, w)
    for g, w in zip(TH.pair_key(t(hi), t(lo), t(h2), t(l2)),
                    JH.pair_key(*(jnp.asarray(x) for x in (hi, lo, h2,
                                                           l2)))):
        same(g, w)


def test_block_addressing(rng):
    """kernels/probe.py block_address and block_bits, the one torch
    spelling of the blocked layout, == the reference's addressing."""
    hi, lo = _words(rng, 3000, 30), _words(rng, 3000)
    for log2 in (16, 22):
        got = KP.block_address(*TH.hash_pair(t(hi), t(lo)), log2)
        for g, w in zip(got, JBL._block_h1r_h2(jnp.asarray(hi),
                                               jnp.asarray(lo), log2)):
            same(g, w)
        for g, w in zip((got[0], KP.block_bits(got[1], got[2], 7)),
                        JBL._block_and_bits(jnp.asarray(hi),
                                            jnp.asarray(lo), 7, log2)):
            same(g, w)


def test_slots(rng):
    cisf = rng.random(200) < 0.5
    base = rng.integers(0, 4, size=200)
    slot = rng.integers(0, 8, size=200)
    ct, bt = torch.from_numpy(cisf), torch.from_numpy(base)
    same(TS.exit_slot(ct, bt), JS.exit_slot(jnp.asarray(cisf),
                                            jnp.asarray(base)))
    same(TS.entry_slot(ct, bt), JS.entry_slot(jnp.asarray(cisf),
                                              jnp.asarray(base)))
    same(TS.slot_base(torch.from_numpy(slot)),
         JS.slot_base(jnp.asarray(slot)))
    same(TS.opposite_side(torch.from_numpy(slot)),
         JS.opposite_side(jnp.asarray(slot)))
    for c in (True, False):
        for b in range(4):
            assert TS.exit_slot(c, b) == JS.exit_slot(c, b)
            assert TS.entry_slot(c, b) == JS.entry_slot(c, b)


def _reads(rng, k, n=24, L=80):
    """Random reads with N bases, short (< k) and empty reads."""
    out = []
    for i, m in enumerate(rng.integers(0, L + 10, size=n)):
        s = "".join(rng.choice(list("ACGTN"), size=int(m),
                               p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        out.append("" if i % 7 == 3 else (s[: k - 2] if i % 5 == 1 else s))
    return out


@pytest.mark.parametrize("k", [21, 31])
def test_kmerize_and_extensions(rng, k):
    bases, lens = JK.pack_reads(_reads(rng, k), 80)
    jv = JK.kmerize(jnp.asarray(bases), jnp.asarray(lens), k)
    tv = TK.kmerize(torch.from_numpy(bases), torch.from_numpy(lens), k)
    for g, w in zip(tv, jv):
        same(g, w)
    ohi, olo = TU.select(tv.canon_is_fwd, tv.rc_hi, tv.rc_lo, tv.fwd_hi,
                         tv.fwd_lo)
    johi, jolo = JU.select(jv.canon_is_fwd, jv.rc_hi, jv.rc_lo, jv.fwd_hi,
                           jv.fwd_lo)
    for b in range(4):
        for jf, tf in ((JK.right_ext, TK.right_ext),
                       (JK.left_ext, TK.left_ext)):
            tx = tf(tv.fwd_hi, tv.fwd_lo, tv.rc_hi, tv.rc_lo, b, k)
            jx = jf(jv.fwd_hi, jv.fwd_lo, jv.rc_hi, jv.rc_lo,
                    np.uint32(b), k)
            for g, w in zip(tx, jx):
                same(g, w)
            for g, w in zip(TK.canon_of(*tx), JK.canon_of(*jx)):
                same(g, w)
    for g, w in zip(TK.slot_ext_pairs(tv.canon_hi, tv.canon_lo, ohi, olo, k),
                    JK.slot_ext_pairs(jv.canon_hi, jv.canon_lo, johi, jolo,
                                      k)):
        same(g, w)
    for tf, jf in ((TND.endpoint_keys, JND.endpoint_keys),
                   (TND.probe_keys, JND.probe_keys)):
        for g, w in zip(tf(tv.canon_hi, tv.canon_lo, ohi, olo, k),
                        jf(jv.canon_hi, jv.canon_lo, johi, jolo, k)):
            same(g, w)


def test_node_keys_palindromes():
    # k=5 -> 4-mer nodes, palindromic ones (ACGT) force side 0
    bases, lens = JK.pack_reads(["AACGTTACGTAAACGT", "ACGTACGTAC"], 16)
    jv = JK.kmerize(jnp.asarray(bases), jnp.asarray(lens), 5)
    tv = TK.kmerize(torch.from_numpy(bases), torch.from_numpy(lens), 5)
    ohi, olo = TU.select(tv.canon_is_fwd, tv.rc_hi, tv.rc_lo, tv.fwd_hi,
                         tv.fwd_lo)
    johi, jolo = JU.select(jv.canon_is_fwd, jv.rc_hi, jv.rc_lo, jv.fwd_hi,
                           jv.fwd_lo)
    for g, w in zip(TND.endpoint_keys(tv.canon_hi, tv.canon_lo, ohi, olo,
                                      5),
                    JND.endpoint_keys(jv.canon_hi, jv.canon_lo, johi, jolo,
                                      5)):
        same(g, w)


def _table_arrays_equal(tt, jt, val_dtypes=None):
    d = CK.table_to_numpy(tt, val_dtypes)
    same(d["keys_hi"], np.asarray(jt.keys_hi))
    same(d["keys_lo"], np.asarray(jt.keys_lo))
    for g, w in zip(d["vals"], jt.vals):
        same(g, np.asarray(w))
    assert int(d["count"]) == int(jt.count)
    assert int(d["dropped"]) == int(jt.dropped)


@pytest.mark.parametrize("cap,max_rounds", [(1 << 10, 128), (1 << 8, 3)])
def test_table_slot_arrays(rng, cap, max_rounds):
    """upsert/lookup slot arrays equal the reference's, including the
    probe-overflow (dropped) accounting of a nearly full table."""
    jt = JT.make(cap, (((8,), jnp.int32), ((8,), jnp.uint16)))
    tt = TT.make(cap, (((8,), torch.int32), ((8,), torch.int32)))
    for _ in range(4):
        n = 300
        hi = rng.integers(0, 6, size=n).astype(np.uint32)
        lo = rng.integers(0, 120, size=n).astype(np.uint32)
        cov = rng.integers(0, 3, size=(n, 8)).astype(np.int32)
        dist = rng.integers(0, 100, size=(n, 8)).astype(np.uint16)
        mask = rng.random(n) < 0.9
        jt = JT.upsert(jt, jnp.asarray(hi), jnp.asarray(lo),
                       (jnp.asarray(cov), jnp.asarray(dist)),
                       jnp.asarray(mask), modes=("add", "max"),
                       max_rounds=max_rounds)
        tt = TT.upsert(tt, t(hi), t(lo),
                       (torch.from_numpy(cov),
                        torch.from_numpy(dist.astype(np.int32))),
                       torch.from_numpy(mask), modes=("add", "max"),
                       max_rounds=max_rounds)
        _table_arrays_equal(tt, jt, (np.int32, np.uint16))
    q_hi = np.concatenate([hi, np.full(16, 9, np.uint32)])
    q_lo = np.concatenate([lo, np.arange(16, dtype=np.uint32)])
    q_m = rng.random(len(q_hi)) < 0.8
    jf, ji = JT.lookup(jt, jnp.asarray(q_hi), jnp.asarray(q_lo),
                       jnp.asarray(q_m), max_rounds=max_rounds)
    tf, ti = TT.lookup(tt, t(q_hi), t(q_lo), torch.from_numpy(q_m),
                       max_rounds=max_rounds)
    same(tf, jf)
    same(torch.where(tf, ti, -1), np.where(np.asarray(jf), np.asarray(ji),
                                           -1))
    same(TT.contains(tt, t(q_hi), t(q_lo), torch.from_numpy(q_m),
                     max_rounds=max_rounds),
         JT.contains(jt, jnp.asarray(q_hi), jnp.asarray(q_lo),
                     jnp.asarray(q_m), max_rounds=max_rounds))
    same(TT.occupied_mask(tt), JT.occupied_mask(jt))


def test_table_converters_roundtrip(rng):
    jt = JT.make(1 << 8, (((), jnp.int32),))
    hi, lo = _words(rng, 100, 30), _words(rng, 100)
    jt = JT.upsert(jt, jnp.asarray(hi), jnp.asarray(lo),
                   (jnp.ones(100, jnp.int32),), jnp.ones(100, bool),
                   modes=("add",))
    tt = CK.table_from_numpy(jt)
    assert tt.capacity == jt.capacity
    _table_arrays_equal(tt, jt)
    # the converted table keeps answering like the reference
    found, _ = TT.lookup(tt, t(hi), t(lo), torch.ones(100, dtype=bool))
    assert bool(found.all())
