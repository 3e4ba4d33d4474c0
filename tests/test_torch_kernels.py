"""faucet_tpu_torch kernel modules (probe, cascade) vs the reference.

On the CPU the wrappers take their plain torch versions; those are held
to the reference's CPU formulation (core/bloom.py) exactly, and to the
Pallas TPU kernels run in interpret mode. Tests marked `cuda` hold the
CUDA kernels to the plain versions on the card; they skip without one.

The reference needs jax, which the GPU machine does not have: jax is
imported inside the `ref` fixture only, so the cuda tests run there with
  python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
(tests/conftest.py imports jax too).
"""
import types

import numpy as np
import pytest
import torch

from faucet_tpu.config import Config
from faucet_tpu_torch.ckpt import state as CK
from faucet_tpu_torch.core import bloom as TBL
from faucet_tpu_torch.core import u32x2 as TU
from faucet_tpu_torch.kernels import cascade as KC
from faucet_tpu_torch.kernels import probe as KP

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)

SENT = 0xFFFFFFFF
JSENT = np.uint32(SENT)


@pytest.fixture(scope="module")
def ref():
    """The reference package's modules (imports jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from faucet_tpu.core import bloom
    from faucet_tpu.kernels.cascade import cascade_insert_fused
    from faucet_tpu.kernels.probe import bloom_probe_keys

    return types.SimpleNamespace(jnp=jnp, BL=bloom,
                                 fused=cascade_insert_fused,
                                 probe=bloom_probe_keys)


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


def _probe_args(words, hi, lo, mask, log2):
    block, h1r, h2 = TBL._block_h1r_h2(TU.u32(hi), TU.u32(lo), log2)
    block = torch.where(torch.from_numpy(mask), block, SENT)
    return words, block, h1r, h2


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
    before = KP.launches
    got = KP.bloom_probe_keys(*_probe_args(tb.words, qhi, qlo, qmask,
                                           log2_bits), n_hash)
    assert KP.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    got = TBL.bloom_contains(tb, TU.u32(qhi), TU.u32(qlo),
                             torch.from_numpy(qmask), n_hash, log2_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[: n_keys // 2][torch.from_numpy(qmask[: n_keys // 2])].all()


def _cfg(la, lb, **kw):
    return Config(size_kmer=31, max_read_length=64,
                  bloom_a_log2_override=la, bloom_b_log2_override=lb, **kw)


def _both_insert(ref, jc, tc, hi, lo, mask, cfg):
    jnp, JBL = ref.jnp, ref.BL
    jc, jnb, jsol = JBL.cascade_insert_nbs(jc, jnp.asarray(hi),
                                           jnp.asarray(lo),
                                           jnp.asarray(mask), cfg)
    tc, tnb, tsol = TBL.cascade_insert_nbs(tc, TU.u32(hi), TU.u32(lo),
                                           torch.from_numpy(mask), cfg)
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
    cfg = _cfg(20, 17)
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
        cfg = _cfg(18, 16, n_hash_a_override=3, n_hash_b_override=3)
        hi = hi | (rng.integers(0, 2, size=n).astype(np.uint32) << 30)
        mask = rng.random(n) < 0.05
    jc = ref.BL.make_cascade(cfg)
    tc = CK.cascade_from_numpy(jc)
    for batch in range(2):
        jc, tc = _both_insert(ref, jc, tc, hi, lo, mask, cfg)
        hi, lo, mask = hi[::-1].copy(), lo[::-1].copy(), mask[::-1].copy()
    if case == "all_masked":
        assert int(tc.a_bloom.words.abs().sum()) == 0


@pytest.mark.parametrize("la,lb,n,dup", [(18, 16, 500, False),
                                         (20, 17, 2000, True)])
def test_cascade_plain_vs_tpu_kernel(ref, rng, la, lb, n, dup):
    """Against the Pallas kernel (interpret mode): filter words identical,
    new_b key multisets equal, and the kernel's solid flags a superset by
    under 3% (it probes B mid-batch, the formulation pre-batch)."""
    jnp, JBL = ref.jnp, ref.BL
    cfg = _cfg(la, lb)
    hi, lo = _keys(rng, n)
    if dup:
        hi, lo = _dup(hi, lo)
    mask = rng.random(n) < 0.9
    c0 = JBL.make_cascade(cfg)
    ba, h1r, h2 = JBL._block_h1r_h2(jnp.asarray(hi), jnp.asarray(lo), la)
    bb, _, _ = JBL._block_h1r_h2(jnp.asarray(hi), jnp.asarray(lo), lb)
    ba = jnp.where(jnp.asarray(mask), ba, JSENT)
    aw, bw, nb_k, sol_k = ref.fused(
        c0.a_bloom.words, c0.b_bloom.words, ba, bb, h1r, h2, cfg.n_hash_a,
        cfg.n_hash_b, with_solid=True, interpret=True)
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
    # CPU tensors take the plain version and count no launch; the CUDA
    # wrapper's checks are exercised on the card (test_kernels_on_card)
    before = (KP.launches, KC.launches)
    assert KP.bloom_probe_keys(w, k + SENT, k, k, 3).sum() == 0
    new_b, solid = KC.cascade_insert(w.clone(), w.clone(), k, k, k + SENT,
                                     k, k, k, 3, 3)
    assert not new_b.any() and not solid.any()
    assert (KP.launches, KC.launches) == before


# ---- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_hash_a", [4, 7])
def test_kernels_on_card(cuda, n_hash_a):
    """CUDA kernels == plain versions bit for bit, two dense batches with
    duplicates, then a ~3%-live sparse batch."""
    rng = np.random.default_rng(12345)
    cfg = _cfg(22, 20, n_hash_a_override=n_hash_a, n_hash_b_override=3)
    n = 200_000
    hi, lo = _dup(*_keys(rng, n))
    cg, cp = TBL.make_cascade(cfg, cuda), TBL.make_cascade(cfg)
    for mask in (rng.random(n) < 0.95, rng.random(n) < 0.95,
                 rng.random(n) < 0.03):
        kl = (KC.launches, KP.launches)
        _, nb_g, sol_g = TBL.cascade_insert_nbs(
            cg, TU.u32(hi).to(cuda), TU.u32(lo).to(cuda),
            torch.from_numpy(mask).to(cuda), cfg)
        torch.cuda.synchronize()
        assert KC.launches == kl[0] + 1 and KP.launches == kl[1] + 2
        _, nb_p, sol_p = TBL.cascade_insert_nbs(
            cp, TU.u32(hi), TU.u32(lo), torch.from_numpy(mask), cfg)
        assert torch.equal(cg.a_bloom.words.cpu(), cp.a_bloom.words)
        assert torch.equal(cg.b_bloom.words.cpu(), cp.b_bloom.words)
        assert torch.equal(nb_g.cpu(), nb_p)
        assert torch.equal(sol_g.cpu(), sol_p)
        hi, lo = hi[::-1].copy(), lo[::-1].copy()
    qhi, qlo = _keys(rng, n)
    qmask = rng.random(n) < 0.9
    g = TBL.bloom_contains(cg.b_bloom, TU.u32(qhi).to(cuda),
                           TU.u32(qlo).to(cuda),
                           torch.from_numpy(qmask).to(cuda), 3, 20)
    p = TBL.bloom_contains(cp.b_bloom, TU.u32(qhi), TU.u32(qlo),
                           torch.from_numpy(qmask), 3, 20)
    assert torch.equal(g.cpu(), p)
    with pytest.raises(ValueError):
        KP.bloom_probe_keys(cg.b_bloom.words, TU.u32(qhi).to(cuda).int(),
                            TU.u32(qhi).to(cuda), TU.u32(qhi).to(cuda), 3)
