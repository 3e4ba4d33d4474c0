"""Plain PyTorch reference of the port's load and scan passes.

It rebuilds, from the reads alone, what the program's load and scan
passes leave behind: the Bloom cascade's filters (A: seen, B: solid, and
at k <= 31 the branch-node cascade's D and E) and the junction and sink
tables by content. It imports nothing of faucet_tpu_torch and takes
nothing the program made: codes, keys, hashes, filter sizes, extension
keys, runs and records are worked out again here, with plain torch
operations, in the configuration's own batches (the cascade's semantics
are per batch: a k-mer is promoted into B when A held it before the
batch, or when it occurs twice in the batch).

Codes: a k-mer's 2k-bit code is the pair (hi, lo) of int64 tensors with
value hi * 2**62 + lo, so one representation serves k <= 31 (hi = 0) and
k <= 63. A base is 0..3 (A, C, G, T), complement 3 - b; the forward code
holds the window's first base at the top. Table and filter keys are the
code's two 32-bit words for k <= 31, and a 62-bit fingerprint of its four
32-bit words above (the same definitions as faucet_tpu's).

Frozen copies, each from faucet_tpu_torch: murmur3's fmix32 and the
two-hash chain (core/hashing.py), the fingerprint (core/wide.py), the
blocked Bloom addressing (kernels/probe.py), the tagged branch-node keys
(core/nodes.py) and the slot conventions (core/slots.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from benchmark import sizing

M32 = 0xFFFFFFFF
MASK62 = (1 << 62) - 1
KEY_LAST = (1 << 63) - 1
SIDE_BIT = 30


# ---- hashing (core/hashing.py, core/wide.py) ---------------------------

def fmix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def hash_pair(hi, lo):
    """(h1, h2) of a pair of 32-bit words; h2 is odd."""
    h1 = fmix32(lo ^ fmix32(hi ^ 0x9E3779B9))
    h2 = fmix32(hi ^ fmix32(lo ^ 0x85EBCA77)) | 1
    return h1, h2


def fingerprint(w0, w1, w2, w3):
    a1, a2 = hash_pair(w0, w1)
    b1, b2 = hash_pair(w2, w3)
    return (fmix32((a1 + 3 * b1) & M32) & 0x3FFFFFFF,
            fmix32(a2 ^ ((b2 * 5) & M32)))


# ---- codes --------------------------------------------------------------

class Code(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def _mask(c: Code, k: int) -> Code:
    if 2 * k <= 62:
        return Code(torch.zeros_like(c.hi), c.lo & ((1 << (2 * k)) - 1))
    return Code(c.hi & ((1 << (2 * k - 62)) - 1), c.lo)


def push_right(c: Code, b, k: int) -> Code:
    """Drop the first base, append b."""
    return _mask(Code((c.hi << 2) | (c.lo >> 60),
                      ((c.lo << 2) & MASK62) | b), k)


def push_left(c: Code, b, k: int) -> Code:
    """Drop the last base, prepend b."""
    hi, lo = c.hi >> 2, (c.lo >> 2) | ((c.hi & 3) << 60)
    top = 2 * (k - 1)
    if top < 62:
        return Code(hi, lo | (b << top))
    return Code(hi | (b << (top - 62)), lo)


def le(x: Code, y: Code):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo <= y.lo))


def where(m, x: Code, y: Code) -> Code:
    return Code(torch.where(m, x.hi, y.hi), torch.where(m, x.lo, y.lo))


def canonical(fwd: Code, rc: Code):
    """(canonical code, the other orientation's code, canonical is fwd)."""
    f = le(fwd, rc)
    return where(f, fwd, rc), where(f, rc, fwd), f


def words(c: Code):
    """The code's four 32-bit words, most significant first."""
    return ((c.hi >> 34) & M32, (c.hi >> 2) & M32,
            (c.lo >> 32) | ((c.hi & 3) << 30), c.lo & M32)


def key(c: Code, k: int):
    """(key_hi, key_lo) of a canonical code."""
    if k <= 31:
        return c.lo >> 32, c.lo & M32
    return fingerprint(*words(c))


def kmerize(bases, lens, k: int):
    """(fwd, rc, valid) of every k-window of a [B, L] batch: [B, P]."""
    B, L = bases.shape
    P = L - k + 1
    ok = bases < 4
    b = torch.where(ok, bases, 0).long()
    z = torch.zeros((B, P), dtype=torch.int64, device=bases.device)
    fwd, rc = Code(z, z), Code(z, z)
    for j in range(k):
        fwd = push_right(fwd, b[:, j:j + P], k)
        rc = push_left(rc, 3 - b[:, j:j + P], k)
    bad = torch.cumsum((~ok).long(), 1)
    bad = bad[:, k - 1:] - torch.nn.functional.pad(bad, (1, 0))[:, :P]
    ends = torch.arange(k - 1, L, device=bases.device)
    valid = (bad == 0) & (ends[None, :] < lens.long()[:, None])
    return fwd, rc, valid


# ---- Bloom filters (kernels/probe.py's blocked layout) -------------------

class Bloom:
    """A blocked Bloom filter as a bit array: a key's n_hash bits lie in
    one 512-bit block, bit j = (rot16(h1) + (j + 1) * h2) & 511."""

    def __init__(self, log2_bits: int, n_hash: int, device):
        self.bits = torch.zeros((1 << log2_bits,), dtype=torch.bool,
                                device=device)
        self.log2, self.n_hash = log2_bits, n_hash

    def positions(self, khi, klo):
        h1, h2 = hash_pair(khi, klo)
        block = h1 & ((1 << (self.log2 - 9)) - 1)
        h1r = (h1 >> 16) | ((h1 << 16) & M32)
        j = torch.arange(1, self.n_hash + 1, device=khi.device)
        return block[..., None] * 512 + ((h1r[..., None]
                                          + j * h2[..., None]) & 511)

    def contains(self, khi, klo, mask):
        return self.bits[self.positions(khi, klo)].all(-1) & mask

    def add(self, khi, klo, mask):
        self.bits[self.positions(khi[mask], klo[mask]).reshape(-1)] = True

    def words(self):
        """int32 words of the filter (bit i of word w = bit 32 w + i)."""
        v = (self.bits.view(-1, 32).long()
             << torch.arange(32, device=self.bits.device)).sum(1)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def cascade_insert(a: Bloom, b: Bloom, khi, klo, live):
    """One batch into the cascade: a key goes into B if A held it before
    the batch or it occurs twice in the batch, else into A. Returns per
    lane (new_b: the key's first lane, where this batch first puts it
    into B; solid: the key was in A or B before the batch, or occurs
    earlier in the batch)."""
    n = khi.shape[0]
    k64 = torch.where(live, (khi << 32) | klo, KEY_LAST)
    skey, sidx = torch.sort(k64, stable=True)
    head = torch.ones((n,), dtype=torch.bool, device=khi.device)
    head[1:] = skey[1:] != skey[:-1]
    grp = torch.cumsum(head.long(), 0) - 1
    size = torch.bincount(grp)
    slive = live[sidx]
    rep = head & slive
    rl = sidx[rep]
    hhi, hlo = khi[rl], klo[rl]
    ones = torch.ones_like(rl, dtype=torch.bool)
    in_a, in_b = a.contains(hhi, hlo, ones), b.contains(hhi, hlo, ones)
    add_b = in_a | (size[grp[rep]] >= 2)
    a.add(hhi, hlo, ~in_a)
    b.add(hhi, hlo, add_b)
    new_b = torch.zeros((n,), dtype=torch.bool, device=khi.device)
    new_b[rl] = add_b & ~in_b
    gflag = torch.zeros_like(size, dtype=torch.bool)
    gflag[grp[rep]] = in_a | in_b
    solid = torch.zeros_like(new_b)
    solid[sidx] = (gflag[grp] | ~head) & slive
    return new_b, solid


def _tagged(n_fwd: Code, n_rc: Code, suffix: bool):
    """Orientation-free key of a (k-1)-node seen as a k-mer's prefix
    (suffix False) or suffix (core/nodes.py)."""
    as_canon = le(n_fwd, n_rc)
    pal = (n_fwd.hi == n_rc.hi) & (n_fwd.lo == n_rc.lo)
    c = where(as_canon, n_fwd, n_rc)
    side = (as_canon if suffix else ~as_canon) & ~pal
    return (c.lo >> 32) | (side.long() << SIDE_BIT), c.lo & M32


def _nodes(canon: Code, other: Code, k: int):
    """(prefix fwd, prefix rc, suffix fwd, suffix rc) (k-1)-node codes."""
    m = (1 << (2 * (k - 1))) - 1
    return (Code(canon.hi, canon.lo >> 2), Code(other.hi, other.lo & m),
            Code(canon.hi, canon.lo & m), Code(other.hi, other.lo >> 2))


def _shift(a, by: int, fill):
    col = torch.full_like(a[:, :1], fill)
    if by > 0:
        return torch.cat([col, a[:, :-1]], 1)
    return torch.cat([a[:, 1:], col], 1)


def _rcummin(a):
    return torch.flip(torch.cummin(torch.flip(a, [1]), 1).values, [1])


class Reference:
    """The load and scan passes of one configuration, batch by batch.

    kw: the program's Config keyword arguments (benchmark/sizing.py);
    hash_delta: added to every filter's hash count (the control, which
    breaks the configuration's false-positive guarantee, uses -1)."""

    def __init__(self, kw: dict, device, hash_delta: int = 0):
        self.k = kw["size_kmer"]
        self.nodes = sizing.uses_nodes(kw)
        self.filters = {name: Bloom(log2, max(1, nh + hash_delta), device)
                        for name, (log2, nh) in sizing.filters(kw).items()}
        self.jrows, self.srows = [], []

    def _insert(self, fwd, rc, valid):
        canon, other, _ = canonical(fwd, rc)
        khi, klo = key(canon, self.k)
        f = self.filters
        new_b, solid = cascade_insert(f["a"], f["b"], khi.reshape(-1),
                                      klo.reshape(-1), valid.reshape(-1))
        if self.nodes:
            p_f, p_r, s_f, s_r = _nodes(canon, other, self.k)
            phi, plo = _tagged(p_f, p_r, suffix=False)
            shi, slo = _tagged(s_f, s_r, suffix=True)
            cascade_insert(f["d"], f["e"],
                           torch.cat([phi.reshape(-1), shi.reshape(-1)]),
                           torch.cat([plo.reshape(-1), slo.reshape(-1)]),
                           torch.cat([new_b, new_b]))
        return solid.view(valid.shape)

    def load(self, bases, lens):
        self._insert(*kmerize(bases, lens, self.k))

    def stream(self, bases, lens):
        """The single-pass step: insert, then scan with the insert's
        per-window solidity."""
        fwd, rc, valid = kmerize(bases, lens, self.k)
        self._scan(bases, fwd, rc, valid, self._insert(fwd, rc, valid))

    def scan(self, bases, lens):
        self._scan(bases, *kmerize(bases, lens, self.k))

    def _scan(self, bases, fwd, rc, valid, solid=None):
        k, f = self.k, self.filters
        canon, other, cisf = canonical(fwd, rc)
        khi, klo = key(canon, k)
        B, P = khi.shape
        solid = (f["b"].contains(khi, klo, valid) if solid is None
                 else solid & valid)
        # the bases just outside each window (4 past the read's end)
        nb = torch.nn.functional.pad(bases[:, k:], (0, 1), value=4)[:, :P]
        nb = nb.clamp(max=3).long()
        pb = _shift(bases[:, :P], 1, 4).clamp(max=3).long()
        ex_slot = torch.where(cisf, nb, 7 - nb)
        en_slot = torch.where(cisf, 4 + pb, 3 - pb)
        if self.nodes:
            p_f, p_r, s_f, s_r = _nodes(canon, other, k)
            rhi, rlo = _tagged(s_f, s_r, suffix=False)
            lhi, llo = _tagged(p_f, p_r, suffix=True)
            is_junc = solid & (f["e"].contains(rhi, rlo, solid)
                               | f["e"].contains(lhi, llo, solid))
        else:
            is_junc = self._ext8(canon, other, solid, valid, ex_slot,
                                 en_slot)
        pos = torch.arange(P, device=bases.device).expand(B, P)
        start = solid & ~_shift(solid, 1, False)
        end = solid & ~_shift(solid, -1, False)
        rs = torch.cummax(torch.where(start, pos, 0), 1).values
        re = _rcummin(torch.where(end, pos, P))
        prev_j = _shift(torch.cummax(torch.where(is_junc, pos, -1), 1).values,
                        1, -1)
        next_j = _shift(_rcummin(torch.where(is_junc, pos, P)), -1, P)
        pj = torch.where(prev_j >= rs, prev_j, -1)
        nj = torch.where(~end & (next_j <= re), next_j, -1)
        ex_dist = torch.where(nj >= 0, nj, re) - pos
        en_dist = pos - torch.where(pj >= 0, pj, rs)
        sl8 = torch.arange(8, device=bases.device)
        ex_oh = (ex_slot[..., None] == sl8) & (is_junc & ~end)[..., None]
        en_oh = (en_slot[..., None] == sl8) & (is_junc & ~start)[..., None]
        cov8 = ex_oh.long() + en_oh.long()
        dist8 = torch.maximum(ex_oh * ex_dist[..., None],
                              en_oh * en_dist[..., None])
        k64 = (khi << 32) | klo
        wcols = (torch.stack(words(canon), -1),) if k > 31 else ()
        j = is_junc
        self.jrows.append((k64[j], cov8[j], dist8[j]) + tuple(
            w[j] for w in wcols))
        s = solid & (start | end)
        self.srows.append((k64[s], (start.long() + end.long())[s])
                          + tuple(w[s] for w in wcols))

    def _ext8(self, canon, other, solid, valid, ex_slot, en_slot):
        """Junctions from the 8 extensions: two or more solid on a side.
        The read answers two of them: the exit slot is the next window's
        k-mer and the entry slot the previous window's, so those take the
        neighbouring windows' solidity and are not probed."""
        k, b_filter = self.k, self.filters["b"]
        sl8 = torch.arange(8, device=solid.device)
        ex_known = (ex_slot[..., None] == sl8) & (
            valid & _shift(valid, -1, False))[..., None]
        en_known = (en_slot[..., None] == sl8) & (
            valid & _shift(valid, 1, False))[..., None]
        fill = ((ex_known & _shift(solid, -1, False)[..., None])
                | (en_known & _shift(solid, 1, False)[..., None])) \
            & solid[..., None]
        known = ex_known | en_known
        ext = []
        for s in range(8):
            if s < 4:
                e = canonical(push_right(canon, s, k),
                              push_left(other, 3 - s, k))[0]
            else:
                e = canonical(push_left(canon, s - 4, k),
                              push_right(other, 7 - s, k))[0]
            ehi, elo = key(e, k)
            ext.append(b_filter.contains(ehi, elo,
                                         solid & ~known[..., s]))
        ext_solid = torch.where(known, fill, torch.stack(ext, -1))
        return solid & ((ext_solid[..., :4].sum(-1) >= 2)
                        | (ext_solid[..., 4:].sum(-1) >= 2))

    def tables(self) -> dict:
        """{"junctions": rows, "sinks": rows}: per key, the junction
        records' cov8 summed and dist8 (and the wide code words) maxed;
        the sink records' coverage summed (and words maxed)."""
        out = {}
        for name, rows, modes in (("junctions", self.jrows,
                                   ("add", "max", "max")),
                                  ("sinks", self.srows, ("add", "max"))):
            cols = [torch.cat(c) for c in zip(*rows)]
            keys, inv = torch.unique(cols[0], return_inverse=True)
            vals = []
            for v, mode in zip(cols[1:], modes):
                o = torch.zeros((keys.shape[0],) + v.shape[1:],
                                dtype=torch.int64, device=v.device)
                if mode == "add":
                    o.index_add_(0, inv, v.long())
                else:
                    idx = inv.view((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
                    o.scatter_reduce_(0, idx, v.long(), "amax",
                                      include_self=False)
                vals.append(o)
            out[name] = (keys, vals)
        return out

    def filter_words(self) -> dict:
        return {n: b.words() for n, b in self.filters.items()}
