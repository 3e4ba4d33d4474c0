"""Wide k-mer codes (k in (31, 63]): four uint32 words + fingerprint keys.

Port of faucet_tpu/core/wide.py. A wide code is four 32-bit words, most
significant first; its table and Bloom key is a 62-bit fingerprint of the
canonical code (hi < 2**30, as narrow keys), so the cascade, the tables
and the scan are width-agnostic; the true words ride along as table values
where walks seed from them.

Word rule (core/u32x2.py): words are int64 tensors holding uint32 values,
every left shift, sum and product masked back to 32 bits. The reference
passes a code as a tuple of four [...] arrays; the port stacks them into
ONE int64 tensor of shape [4, ...] (word 0 first), so a word operation is
one launch over all four words, not four. The host helpers (numpy / int)
are copied from the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from faucet_tpu_torch.core.hashing import (M32, fmix32, fmix32_np,
                                           hash_pair, hash_pair_np)
from faucet_tpu_torch.core.kmer import encode_seq

NW = 4  # words per wide code


def _cat_zero(parts, where: str):
    """parts [3, ...] with a zero word appended ("tail") or prepended."""
    z = torch.zeros_like(parts[:1])
    return torch.cat([parts, z] if where == "tail" else [z, parts])


def wshl2(w):
    """The code shifted left by one base (bits past word 0's top kept in
    the 32-bit words, as the reference's uint32 shifts drop them)."""
    return ((w << 2) & M32) | _cat_zero(w[1:] >> 30, "tail")


def wshr2(w):
    """The code shifted right by one base, logical."""
    return (w >> 2) | _cat_zero((w[:-1] << 30) & M32, "head")


def wor_at(w, v, bitpos: int):
    """OR 2-bit v at static bit offset `bitpos` (0 = LSB of word 3); v is
    an int or a tensor broadcastable to a word, and the result takes the
    broadcast shape (the walk extends a [4, W] frame by 4 bases at once)."""
    word = 3 - bitpos // 32
    out = list(w.unbind(0))
    out[word] = out[word] | ((v << (bitpos % 32)) & M32)
    return torch.stack(torch.broadcast_tensors(*out))


def wor_low(w, v):
    """OR v into word 3 (broadcasting as wor_at)."""
    return wor_at(w, v, 0)


def _low_masks(nbits: int):
    """Per-word masks keeping the low nbits (static) of a code."""
    out = []
    for i in range(NW):
        lo_bit = 32 * (NW - 1 - i)  # bit offset of word i's LSB
        if nbits <= lo_bit:
            out.append(0)
        elif nbits < lo_bit + 32:
            out.append((1 << (nbits - lo_bit)) - 1)
        else:
            out.append(M32)
    return out


def wmask(w, nbits: int):
    """Keep the low nbits (static)."""
    m = torch.tensor(_low_masks(nbits), dtype=w.dtype, device=w.device)
    return w & m.view((NW,) + (1,) * (w.dim() - 1))


def wle(x, y):
    """x <= y, lexicographic over the words (unsigned: the words are
    non-negative int64)."""
    lt, eq = x < y, x == y
    res = lt[3] | eq[3]
    for i in range(NW - 2, -1, -1):
        res = lt[i] | (eq[i] & res)
    return res


def weq(x, y):
    return (x == y).all(dim=0)


def wselect(pred, x, y):
    """pred ? x : y, word by word (pred broadcasts to a word)."""
    return torch.where(pred, x, y)


def fingerprint(w):
    """Canonical code [4, ...] -> (hi < 2**30, lo) table/Bloom key; the
    two hash_pair calls of the reference run as one on words (0, 2) and
    (1, 3)."""
    h1, h2 = hash_pair(w[0::2], w[1::2])
    f = fmix32(torch.stack([(h1[0] + 3 * h1[1]) & M32,
                            h2[0] ^ ((h2[1] * 5) & M32)]))
    return f[0] & 0x3FFFFFFF, f[1]


# ---- kmerization -----------------------------------------------------------


class WideView(NamedTuple):
    fwd: torch.Tensor           # [4, B, P] forward code
    rc: torch.Tensor            # [4, B, P] reverse-complement code
    canon: torch.Tensor         # [4, B, P]
    canon_is_fwd: torch.Tensor  # [B, P]
    valid: torch.Tensor         # [B, P]
    key_hi: torch.Tensor        # [B, P] fingerprint of canon
    key_lo: torch.Tensor


def _pack(win, offs, k: int):
    """Words of sum_j win[..., j] << offs[j] (disjoint 2-bit fields, so
    the sum is the reference's OR); offs[j] = bit offset of base j from
    word 3's LSB. The bases of one word form a run of j, summed at once."""
    words = []
    for i in range(NW):
        js = [j for j in range(k) if 3 - offs[j] // 32 == i]
        if not js:
            words.append(torch.zeros(win.shape[:-1], dtype=torch.int64,
                                     device=win.device))
            continue
        j0, j1 = min(js), max(js) + 1
        sh = torch.tensor([offs[j] % 32 for j in range(j0, j1)],
                          dtype=torch.int64, device=win.device)
        words.append((win[..., j0:j1] << sh).sum(-1))
    return torch.stack(words)


def kmerize_wide(bases, lens, k: int) -> WideView:
    """All wide k-windows of a read batch: base j of a window lands at bit
    2(k-1-j) of fwd and bit 2j of rc (bit-identical to the reference's
    per-base loop); each word is one sum over an unfolded view."""
    B, L = bases.shape
    P = L - k + 1
    assert P >= 1
    dev = bases.device
    ok = bases < 4
    win = torch.where(ok, bases, 0).to(torch.int64).unfold(1, k, 1)
    fwd = _pack(win, [2 * (k - 1 - j) for j in range(k)], k)
    rc = _pack(3 - win, [2 * j for j in range(k)], k)

    cbad = torch.cumsum((~ok).to(torch.int32), dim=1)
    prev = torch.nn.functional.pad(cbad, (1, 0))[:, :P]
    bad_in_win = cbad[:, k - 1:] - prev
    ends = torch.arange(k - 1, L, device=dev)[None, :]
    valid = (bad_in_win == 0) & (ends < lens.to(dev)[:, None])
    cisf = wle(fwd, rc)
    canon = wselect(cisf, fwd, rc)
    khi, klo = fingerprint(canon)
    return WideView(fwd=fwd, rc=rc, canon=canon, canon_is_fwd=cisf,
                    valid=valid, key_hi=khi, key_lo=klo)


def right_ext_wide(fwd, rc, b, k: int):
    """Append base b on the right of the (fwd, rc) frame; b is an int or
    a tensor broadcastable to a word."""
    nf = wmask(wor_low(wshl2(fwd), b), 2 * k)
    nr = wor_at(wshr2(rc), 3 - b, 2 * (k - 1))
    return nf, nr


def left_ext_wide(fwd, rc, c, k: int):
    """Prepend base c on the left of the (fwd, rc) frame."""
    nf = wor_at(wshr2(fwd), c, 2 * (k - 1))
    nr = wmask(wor_low(wshl2(rc), 3 - c), 2 * k)
    return nf, nr


def canon_of_wide(fwd, rc):
    cisf = wle(fwd, rc)
    return wselect(cisf, fwd, rc), cisf


def wtop_base(fwd, k: int):
    bitpos = 2 * (k - 1)
    return (fwd[3 - bitpos // 32] >> (bitpos % 32)) & 3


# ---- host helpers (numpy / int; from faucet_tpu/core/wide.py, the window
# keys built from a window view and in a many-strings form) ------------------

_WINDOW_CHUNK = 1 << 16  # windows per shifted sum in _window_words_np


def revcomp_words_np(words: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of 4-word (128-bit container) codes
    (host numpy). words: uint32[n, 4], big-endian word order, value
    right-aligned to 2k bits."""
    w = np.asarray(words, np.uint64)
    hi = (w[:, 0] << np.uint64(32)) | w[:, 1]
    lo = (w[:, 2] << np.uint64(32)) | w[:, 3]
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)

    def rev64(v):
        v = ((v >> np.uint64(2)) & m2) | ((v & m2) << np.uint64(2))
        v = ((v >> np.uint64(4)) & m4) | ((v & m4) << np.uint64(4))
        return v.byteswap()

    rhi, rlo = rev64(~lo), rev64(~hi)  # full-128 2-bit-group reversal
    s = 128 - 2 * k
    if 0 < s < 64:
        s = np.uint64(s)
        rlo = (rlo >> s) | (rhi << (np.uint64(64) - s))
        rhi = rhi >> s
    elif s >= 64:
        rlo = rhi >> np.uint64(s - 64)
        rhi = np.zeros_like(rhi)
    mask2k = (np.uint64(1) << np.uint64(max(2 * k - 64, 0))) - np.uint64(1)
    rhi = rhi & mask2k
    out = np.empty_like(np.asarray(words, np.uint32))
    out[:, 0] = (rhi >> np.uint64(32)).astype(np.uint32)
    out[:, 1] = (rhi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 2] = (rlo >> np.uint64(32)).astype(np.uint32)
    out[:, 3] = (rlo & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def fingerprint_keys_np(words: np.ndarray) -> np.ndarray:
    """uint32[n, 4] canonical codes -> uint64 fingerprint table keys
    (bit-identical to the device fingerprint), vectorized."""
    w = np.asarray(words, np.uint32)
    hi, lo = fingerprint_np((w[:, 0], w[:, 1], w[:, 2], w[:, 3]))
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64)


def _window_words_np(t: np.ndarray, k: int) -> np.ndarray:
    """uint32[n, 4] forward words of every k-window of ACGT codes t (each
    < 4): one shifted sum per word over a [n, k] window view, the fields
    disjoint, so the sum is the reference's shift-OR. A few numpy calls
    per chunk of windows, where the reference's loop makes six per base."""
    from numpy.lib.stride_tricks import sliding_window_view

    win = sliding_window_view(t, k)
    out = np.zeros((win.shape[0], NW), np.uint64)
    offs = 2 * (k - 1 - np.arange(k))
    for i in range(NW):
        js = np.nonzero(3 - offs // 32 == i)[0]
        if not len(js):
            continue
        sh = (offs[js] % 32).astype(np.uint64)
        for a in range(0, win.shape[0], _WINDOW_CHUNK):  # bounds the temps
            b = a + _WINDOW_CHUNK
            out[a:b, i] = (win[a:b, js[0]:js[-1] + 1] << sh).sum(axis=1)
    return out.astype(np.uint32)


def _loop_words_np(t: np.ndarray, k: int) -> np.ndarray:
    """uint32[n, 4] forward words of every k-window of codes t, by the
    reference's k-step shift-OR over 64-bit halves."""
    n = len(t) - k + 1
    hi = np.zeros((n,), np.uint64)
    lo = np.zeros((n,), np.uint64)
    for j in range(k):
        hi = ((hi << np.uint64(2)) | (lo >> np.uint64(62)))
        lo = (lo << np.uint64(2)) | t[j : j + n]
    hi = hi & ((np.uint64(1) << np.uint64(max(2 * k - 64, 0)))
               - np.uint64(1))
    return np.stack([(hi >> np.uint64(32)).astype(np.uint32),
                     (hi & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (lo >> np.uint64(32)).astype(np.uint32),
                     (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=1)


def _fwd_words_np(t: np.ndarray, k: int) -> np.ndarray:
    """Forward words of every k-window of codes t: the window view for
    ACGT codes; the reference's loop where an N (code 4) ORs into its
    neighbour's field, which the view's sum would not reproduce."""
    if int(t.max()) < 4:
        return _window_words_np(t, k)
    return _loop_words_np(t, k)


def _canon_keys_np(fwd: np.ndarray, k: int) -> np.ndarray:
    """Fingerprint keys of the canonical forms of forward words [n, 4]."""
    rc = revcomp_words_np(fwd, k)
    # lexicographic min over the 128-bit values
    fw = fwd.astype(np.uint64)
    rw = rc.astype(np.uint64)
    n = fwd.shape[0]
    lt = np.zeros((n,), bool)
    gt = np.zeros((n,), bool)
    for c in range(4):
        lt = lt | (~gt & (fw[:, c] < rw[:, c]))
        gt = gt | (~lt & (fw[:, c] > rw[:, c]))
    canon = np.where(lt[:, None] | ~gt[:, None], fwd, rc)
    return fingerprint_keys_np(canon)


def encode_windows_wide_np(seq: str, k: int) -> np.ndarray:
    """Fingerprint keys of every canonical k-window of a host string,
    vectorized (the wide analog of kmer.encode_windows_np)."""
    t = encode_seq(seq).astype(np.uint64)
    if len(seq) < k:
        return np.zeros((0,), np.uint64)
    return _canon_keys_np(_fwd_words_np(t, k), k)


def encode_windows_wide_many_np(seqs, k: int) -> np.ndarray:
    """encode_windows_wide_np of every string, concatenated in order, in
    one pass over the joined strings (windows that straddle two strings
    are dropped: each kept window reads only its own k bases)."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    if not len(lens) or int(lens.max(initial=0)) < k:
        return np.zeros((0,), np.uint64)
    t = encode_seq("".join(seqs)).astype(np.uint64)
    end = np.repeat(np.cumsum(lens), lens)  # end of each base's string
    g = np.arange(len(t) - k + 1)
    keep = g + k <= end[g]
    return _canon_keys_np(_fwd_words_np(t, k)[keep], k)


def fingerprint_np(words):
    """Host numpy mirror of fingerprint (bit-identical); both hash_pair
    calls and both finalizers run on stacked arrays."""
    w = [np.asarray(x, np.uint32) for x in words]
    h1, h2 = hash_pair_np(np.stack([w[0], w[2]]), np.stack([w[1], w[3]]))
    with np.errstate(over="ignore"):
        f = fmix32_np(np.stack([h1[0] + np.uint32(3) * h1[1],
                                h2[0] ^ (h2[1] * np.uint32(5))]))
    return f[0] & np.uint32(0x3FFFFFFF), f[1]


def encode_kmer_wide(s: str):
    v = 0
    for c in encode_seq(s):
        assert c < 4
        v = (v << 2) | int(c)
    return tuple((v >> (32 * (NW - 1 - i))) & 0xFFFFFFFF
                 for i in range(NW))


def decode_kmer_wide(words, k: int) -> str:
    v = 0
    for w in words:
        v = (v << 32) | int(w)
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))
