"""Owner-routed frontier walks: an explicit all_to_all per hop (port of
faucet_tpu/dist/swalk.py).

The frontier's lanes are split over the ranks; every hop's 4-way
extension probes, the resolver's lookahead probes and the junction tests
travel by dist/route.py's lossless all_to_all to the rank that owns the
k-mer's hash range and back. Bit-identical to the local walk by
construction (the same membership answers in the same lockstep
recurrence), with the routed bytes counted per wave call. One exchange
answers the solidity and junction tests of every extension up to a few
steps ahead (walk_round_routed), so the walk makes one routed round trip
per several steps.

Byte accounting is the reference's, analytic from the executed rounds:
per step a rank's Wl lanes issue one 4*Wl-lane solidity query and one
Wl-lane junction query; each resolve between rounds probes at most
_resolve_cap(Wl) candidates (4C lanes) and then fp_lookahead steps of
64C beam children. Each routed lane moves 8 B of key out and 1 B of
answer back, over n_shards * cap buckets. The count is float32, as the
reference's (its per-round constant can pass 2**31).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core.hashing import hash_pair_np
from faucet_tpu_torch.dist.mesh import Mesh
from faucet_tpu_torch.dist.sharded import _cap_for, routed_query_fn
from faucet_tpu_torch.graph import walk as W


def routed_bytes(n_shards: int, lanes: int, rounds: int, n_steps: int,
                 fp_lookahead: int) -> int:
    """Routed bytes of one wave call, summed over the ranks (float32)."""
    cap = lambda m: _cap_for(m, n_shards)
    C = W._resolve_cap(lanes)
    step_b = n_shards * (cap(4 * lanes) + cap(lanes)) * 9
    res_b = n_shards * (cap(4 * C) + int(fp_lookahead) * cap(64 * C)) * 9
    per_rank = np.float32(rounds) * np.float32(n_steps * step_b + res_b)
    total = np.float32(0)
    for _ in range(n_shards):
        total = np.float32(total + per_rank)
    return int(total)


# keys one rank may ask per exchange of a routed walk round: the walk
# looks as many steps ahead as this allows (at most MAX_AHEAD). An
# exchange costs about the same at any size this small, so narrow
# frontiers (a handful of long walks, most of a build's steps) take 4
# steps per exchange and wide ones 1
AHEAD_KEYS = 1 << 13
MAX_AHEAD = 4


def _owner_np(hi, lo, shard_bits: int):
    h1, _ = hash_pair_np(hi, lo)
    return (h1 >> np.uint32(32 - shard_bits)).astype(np.int64)


def route_query_np(mesh: Mesh, hi, lo, mask, n_shards: int,
                   shard_bits: int, answer):
    """dist/route.py's route_query for host numpy lanes (int64 hi/lo
    words, bool mask): the same buckets, header row, rounds and
    exchanges, at a numpy op's cost per step instead of a torch op's.
    answer(hi, lo, mask) -> int64 [n_shards*cap] runs at the owner.
    Returns int64 answers, 0 where unmasked."""
    S, n = n_shards, hi.shape[0]
    cap = _cap_for(n, S)
    owner = _owner_np(hi, lo, shard_bits)
    counts = np.bincount(owner[mask], minlength=S)
    local = -(-int(counts.max()) // cap) if n else 0
    got = np.zeros(n, np.int64)
    idx = np.arange(n)
    pending, r, rounds = mask, 0, 1
    while r < rounds:
        key = np.where(pending, owner, S)
        order = np.argsort(key, kind="stable")
        skey = key[order]
        start = np.ones(n, bool)
        start[1:] = skey[1:] != skey[:-1]
        rank = np.empty(n, np.int64)
        rank[order] = idx - np.maximum.accumulate(np.where(start, idx, 0))
        ok = pending & (rank < cap)
        row, col = np.where(ok, owner, S), np.minimum(rank, cap - 1)
        buf = np.zeros((S + 1, cap + 1, 3), np.int64)
        buf[row, col] = np.stack([hi, lo, pending], 1) * ok[:, None]
        buf[:S, cap, 0] = local
        recv = mesh.all_to_all(torch.from_numpy(buf[:S])).numpy()
        if r == 0:
            rounds = max(int(recv[:, cap, 0].max()), 1)
            mesh.stats["carry_rounds"] += rounds - 1
        rows = recv[:, :cap].reshape(S * cap, 3)
        ans = answer(rows[:, 0], rows[:, 1], rows[:, 2] > 0)
        back = mesh.all_to_all(torch.from_numpy(
            np.ascontiguousarray(ans.reshape(S, cap)))).numpy()
        back = np.concatenate([back, np.zeros((1, cap), np.int64)])
        got = np.where(ok, back[row, col], got)
        pending = pending & ~ok
        r += 1
    return got


def _ahead(lanes: int, left: int) -> int:
    """Steps one exchange covers: the deepest tree of 4-way extensions
    (4 + 16 + ... keys per lane) inside AHEAD_KEYS."""
    d, keys = 1, 4
    while d < min(MAX_AHEAD, left) and lanes * (keys + 4 ** (d + 1)) \
            <= AHEAD_KEYS:
        d += 1
        keys += 4 ** d
    return d


def walk_round_routed(cascade, junctions, fr: W.Frontier, n_steps: int,
                      cfg, query):
    """walk_round with its routed queries batched over the steps ahead,
    on host numpy lanes.

    Each exchange asks, for every active lane, about all its descendants
    up to d steps ahead (4 + 16 + ... + 4**d k-mers): their solidity in B
    and their junction membership, both answered by the owner from the
    one key (query(hi, lo, mask) -> bits: 1 solid, 2 junction). The lane
    then takes its d steps from those answers: the same recurrence
    (forced first base, dead, ambiguous, circle and junction ends) and
    the same answers as walk_round with routed oracles, a step being the
    answered child of the previous one; the branches not taken are
    dropped. d (_ahead) depends only on the lane count and the steps
    left, so every rank makes the same exchanges."""
    k = cfg.size_kmer
    top, mask = 2 * (k - 1), (1 << (2 * k)) - 1
    home = fr.fhi.device
    npy = lambda t: t.cpu().numpy()
    f = (npy(fr.fhi) << 32) | npy(fr.flo)
    r = (npy(fr.rhi) << 32) | npy(fr.rlo)
    t0 = (npy(fr.t0hi) << 32) | npy(fr.t0lo)
    forced, circle_ok = npy(fr.forced), npy(fr.circle_ok)
    active, end_kind = npy(fr.active), npy(fr.end_kind)
    entry, steps = npy(fr.entry_slot), npy(fr.steps)
    Wn = f.shape[0]
    b4 = np.arange(4, dtype=np.int64)[:, None, None]
    rb4 = (3 - b4) << (2 * (k - 1))
    lanes = np.arange(Wn)
    outs = []
    s = 0
    while s < n_steps:
        d = _ahead(Wn, n_steps - s)
        # the tree of extensions: level i holds 4**i codes per lane,
        # child c of node n at index 4n + c
        F, Rc = [f[None]], [r[None]]
        for _ in range(d):
            nf = ((F[-1][None] << 2) & mask) | b4      # [4, 4**i, W]
            nr = (Rc[-1][None] >> 2) | rb4
            F.append(nf.transpose(1, 0, 2).reshape(-1, Wn))
            Rc.append(nr.transpose(1, 0, 2).reshape(-1, Wn))
        keys = np.concatenate([np.minimum(F[i], Rc[i]).reshape(-1)
                               for i in range(1, d + 1)])
        bits = query(keys >> 32, keys & 0xFFFFFFFF, np.concatenate(
            [np.broadcast_to(active, (4 ** i, Wn)).reshape(-1)
             for i in range(1, d + 1)]))
        levels = np.split(bits, np.cumsum([4 ** i * Wn
                                           for i in range(1, d)]))
        node = np.zeros(Wn, np.int64)
        for j in range(d):
            lv = levels[j].reshape(-1, Wn)
            a = active
            solid4 = (lv[node[None] * 4 + b4[:, :, 0], lanes] & 1 > 0) & a
            cnt = solid4.sum(0)
            free = a & (forced < 0) if s == 0 else a
            dead = free & (cnt == 0)
            ambig = free & (cnt >= 2)
            bsel = solid4.argmax(0)
            if s == 0:
                bsel = np.where(forced >= 0, forced, bsel)
            advance = a & ~dead & ~ambig
            pbase = (f >> top) & 3
            node = node * 4 + bsel
            f = np.where(advance, F[j + 1][node, lanes], f)
            r = np.where(advance, Rc[j + 1][node, lanes], r)
            circ = advance & circle_ok & (f == t0)
            cisf = f <= r
            at_junc = (lv[node, lanes] & 2 > 0) & advance & ~circ
            eslot = np.where(cisf, 4 + pbase, 3 - pbase)
            end_kind = np.where(dead, W.END_DEAD, end_kind)
            end_kind = np.where(ambig, W.END_AMBIG, end_kind)
            end_kind = np.where(circ, W.END_CIRCULAR, end_kind)
            end_kind = np.where(at_junc, W.END_JUNCTION, end_kind)
            entry = np.where(at_junc, eslot, entry)
            active = advance & ~circ & ~at_junc
            outs.append(np.where(advance, bsel, 255).astype(np.uint8))
            steps = steps + advance
            s += 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(home)
    new = fr._replace(fhi=t(f >> 32), flo=t(f & 0xFFFFFFFF), rhi=t(r >> 32),
                      rlo=t(r & 0xFFFFFFFF), forced=t(np.full(Wn, -1)),
                      active=t(active), end_kind=t(end_kind),
                      entry_slot=t(entry), steps=t(steps))
    bases = t(np.stack(outs, 1) if outs else np.zeros((Wn, 0), np.uint8))
    return new, bases


def walk_waves_routed(mesh: Mesh, cascade_l: BL.Cascade, junc_keys,
                      fr_l, n_rounds: int, n_steps: int, cfg):
    """walk_waves over this rank's lanes with owner-routed probes.

    cascade_l: this rank's cascade slice; junc_keys: this rank's junction
    keys, packed and sorted (the owner answers junction tests).

    The lanes live in host memory, where gloo exchanges (nccl ranks copy
    each buffer to their card and back): a walk step's bookkeeping and
    routing are numpy (walk_round_routed, route_query_np) and launch
    nothing on a card that several ranks may share; the owner's probe
    (B1) runs on the cascade's device, its keys copied there in one
    buffer and its answers back. Between rounds the resolver's probes
    route as torch (dist/route.py). Returns (frontier, bases
    u8[Wl, n_rounds*n_steps], routed bytes of the call over all ranks),
    on fr_l's device."""
    cfg_local = cfg.local_shard()
    S, sb = cfg.n_shards, cfg.shard_bits
    home, dev = fr_l.steps.device, cascade_l.b_bloom.words.device
    host = torch.device("cpu")
    owned = junc_keys.cpu().numpy()

    def solid(h, l, m):
        q = torch.stack([h, l, m.to(h.dtype)]).to(dev)
        return BL.cascade_solid(cascade_l, q[0], q[1], q[2] > 0,
                                cfg_local).to(h.device)

    def answer(hi, lo, m):
        """Owner side: bit 0 solid in B (the probe kernel), bit 1 a
        junction key of this rank."""
        sol = solid(*(torch.from_numpy(np.ascontiguousarray(x))
                      for x in (hi, lo, m))).numpy()
        keys = (hi << 32) | lo
        hit = np.zeros(len(keys), bool)
        if len(owned):
            i = np.minimum(np.searchsorted(owned, keys), len(owned) - 1)
            hit = owned[i] == keys
        return sol.astype(np.int64) | ((hit & m).astype(np.int64) << 1)

    query = lambda h, l, m: route_query_np(mesh, h, l, m, S, sb, answer)
    # one continue flag for all ranks: each must run the same rounds
    any_fn = lambda m: mesh.pmax(int(bool(m.any()))) > 0
    fr2, bases, r = W.walk_waves(
        cascade_l, None, type(fr_l)(*(f.to(host) for f in fr_l)), n_rounds,
        n_steps, cfg_local,
        walk_fn=functools.partial(walk_round_routed, query=query),
        resolve_fn=functools.partial(
            W.resolve_ambiguous, any_fn=any_fn,
            solid_fn=routed_query_fn(mesh, S, sb, solid)),
        any_fn=any_fn)
    return (type(fr2)(*(f.to(home) for f in fr2)), bases.to(home),
            routed_bytes(S, fr_l.active.shape[0], r, n_steps,
                         cfg.fp_lookahead))
