"""Device frontier walk: lockstep contig reconstruction through filter B.

Port of faucet_tpu/graph/walk.py: narrow codes (k <= 31, Frontier) and
four-word wide codes (FrontierW, core/wide.py). All walks advance in
lockstep: each step is one batched 4-way solidity probe (the probe kernel
on CUDA) plus a junction-membership test over the frontier, with per-lane
masks retiring finished walks.

End kinds: 0 running, 1 hit junction, 2 dead end, 3 circular, 4 ambiguous
(transient: resolve_ambiguous judges each such retirement exactly once).

torch has no device loop: the reference's lax.scan over steps and its
while_loop over rounds are host loops here (one sync per round for the
convergence test). Inside a round the codes travel as one packed int64
per strand (k <= 31 codes fit 62 bits), which halves the launches of the
two-word form; the Frontier keeps the reference's (hi, lo) fields.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.core import u32x2 as u2
from faucet_tpu_torch.core import wide as WD
from faucet_tpu_torch.core.slots import entry_slot

RUNNING, END_JUNCTION, END_DEAD, END_CIRCULAR, END_AMBIG = range(5)
M32 = 0xFFFFFFFF

# resolver lane cap floor (see the reference): the effective cap scales
# with the frontier (_resolve_cap)
RESOLVE_CAP = 1024
BEAM = 4


def _resolve_cap(n: int) -> int:
    return int(min(n, max(RESOLVE_CAP, n // 8)))


def _scatter_resolved(fr, lanes, amb, resolved, forced_new):
    """Scatter a compacted resolver verdict back to the full frontier:
    resolved lanes re-arm with their forced base; processed-but-
    unresolved lanes retire END_DEAD."""
    n = fr.forced.shape[0]
    res_full = torch.zeros((n,), dtype=torch.bool, device=lanes.device)
    res_full[lanes] = resolved
    proc_full = torch.zeros_like(res_full)
    proc_full[lanes] = amb
    forced_full = torch.zeros_like(fr.forced)
    forced_full[lanes] = forced_new
    return fr._replace(
        forced=torch.where(res_full, forced_full, fr.forced),
        active=fr.active | res_full,
        end_kind=torch.where(
            res_full, RUNNING,
            torch.where(proc_full & (fr.end_kind == END_AMBIG),
                        END_DEAD, fr.end_kind)))


class Frontier(NamedTuple):
    fhi: torch.Tensor   # current travel-frame forward code [W]
    flo: torch.Tensor
    rhi: torch.Tensor   # current travel-frame revcomp code
    rlo: torch.Tensor
    t0hi: torch.Tensor  # start travel-frame forward code (circle check)
    t0lo: torch.Tensor
    forced: torch.Tensor      # int64: first base to take, -1 = free choice
    circle_ok: torch.Tensor   # bool: detect return-to-start (sink walks)
    active: torch.Tensor      # bool
    end_kind: torch.Tensor    # int64
    entry_slot: torch.Tensor  # int64, valid when end_kind == END_JUNCTION
    steps: torch.Tensor       # int64 bases appended


def make_frontier(chi, clo, rchi, rclo, dirs, forced, active,
                  circle_ok) -> Frontier:
    """Seeds: canonical codes + their revcomp codes; dirs 0 = travel in
    canonical orientation, 1 = travel in revcomp orientation."""
    fwd = dirs == 0
    fhi, flo = u2.select(fwd, chi, clo, rchi, rclo)
    rhi, rlo = u2.select(fwd, rchi, rclo, chi, clo)
    n = chi.shape[0]
    full = lambda v: torch.full((n,), v, dtype=torch.int64,
                                device=chi.device)
    return Frontier(
        fhi=fhi, flo=flo, rhi=rhi, rlo=rlo, t0hi=fhi, t0lo=flo,
        forced=forced.to(torch.int64), circle_ok=circle_ok.bool(),
        active=active.bool(), end_kind=full(RUNNING), entry_slot=full(-1),
        steps=full(0))


class _Ext:
    """Right extension by each of the 4 bases on packed codes: a code f
    with revcomp r becomes ((f << 2) | b) & mask with revcomp
    (r >> 2) | ((3 - b) << 2(k-1)); `extra` leading dims broadcast."""

    def __init__(self, k: int, device, extra: int = 0):
        b = torch.arange(4, device=device).view((4,) + (1,) * (extra + 1))
        self.mask = (1 << (2 * k)) - 1
        self.b = b
        self.rb = (3 - b) << (2 * (k - 1))

    def __call__(self, f, r):
        return ((f << 2) & self.mask) | self.b, (r >> 2) | self.rb


def sorted_member(keys_sorted: torch.Tensor):
    """Junction oracle over the occupied keys of a table, packed and
    sorted: (chi, clo, mask) -> bool. It answers exactly what
    table.lookup's `found` answers (a key sits on its own probe chain,
    which holds no EMPTY before it, and tables never delete) with one
    searchsorted instead of host-synced probe rounds."""
    n = keys_sorted.shape[0]

    def fn(chi, clo, m):
        if n == 0:
            return torch.zeros_like(m)
        q = u2.pack(chi, clo)
        i = torch.clamp(torch.searchsorted(keys_sorted, q), max=n - 1)
        return (keys_sorted[i] == q) & m

    return fn


def walk_round(cascade: BL.Cascade, junctions: T.Table, fr: Frontier,
               n_steps: int, cfg, solid_fn=None, junc_fn=None
               ) -> Tuple[Frontier, torch.Tensor]:
    """Advance every active walk by up to n_steps bases.

    Returns (frontier, bases uint8[W, n_steps]; 255 where lane inactive).
    solid_fn / junc_fn: injectable (chi, clo, mask) oracles, as in the
    reference; junc_fn defaults to table.lookup."""
    k = cfg.size_kmer
    if solid_fn is None:
        solid_fn = lambda chi, clo, m: BL.cascade_solid(cascade, chi,
                                                        clo, m, cfg)
    if junc_fn is None:
        junc_fn = lambda chi, clo, m: T.lookup(
            junctions, chi, clo, m, shard_bits=cfg.shard_bits)[0]
    top = 2 * (k - 1)
    ext = _Ext(k, fr.fhi.device)
    f, r = u2.pack(fr.fhi, fr.flo), u2.pack(fr.rhi, fr.rlo)
    t0 = u2.pack(fr.t0hi, fr.t0lo)
    active, end_kind = fr.active, fr.end_kind
    entry, steps = fr.entry_slot, fr.steps
    W = f.shape[0]
    outs = []
    for s in range(n_steps):
        a = active
        nf4, nr4 = ext(f, r)                      # [4, W]
        c4 = torch.minimum(nf4, nr4)
        solid4 = solid_fn(c4 >> 32, c4 & M32, a.expand(4, W))
        cnt = solid4.sum(0)
        # only the first step of a round honours forced bases (the
        # reference resets forced to -1 after it)
        free = a & (fr.forced < 0) if s == 0 else a
        dead = free & (cnt == 0)
        ambig = free & (cnt >= 2)
        bsel = solid4.to(torch.uint8).argmax(0)   # first solid base
        if s == 0:
            bsel = torch.where(fr.forced >= 0, fr.forced, bsel)
        advance = a & ~dead & ~ambig
        pbase = (f >> top) & 3
        f = torch.where(advance, nf4.gather(0, bsel[None])[0], f)
        r = torch.where(advance, nr4.gather(0, bsel[None])[0], r)
        circ = advance & fr.circle_ok & (f == t0)
        cisf = f <= r
        c = torch.where(cisf, f, r)
        at_junc = junc_fn(c >> 32, c & M32, advance & ~circ)
        eslot = torch.where(cisf, 4 + pbase, 3 - pbase)
        end_kind = torch.where(dead, END_DEAD, end_kind)
        end_kind = torch.where(ambig, END_AMBIG, end_kind)
        end_kind = torch.where(circ, END_CIRCULAR, end_kind)
        end_kind = torch.where(at_junc, END_JUNCTION, end_kind)
        entry = torch.where(at_junc, eslot, entry)
        active = advance & ~circ & ~at_junc
        outs.append(torch.where(advance, bsel, 255).to(torch.uint8))
        steps = steps + advance
    fhi, flo = u2.unpack(f)
    rhi, rlo = u2.unpack(r)
    new = fr._replace(fhi=fhi, flo=flo, rhi=rhi, rlo=rlo,
                      forced=torch.full_like(fr.forced, -1), active=active,
                      end_kind=end_kind, entry_slot=entry, steps=steps)
    bases = (torch.stack(outs, dim=1) if outs else
             torch.empty((W, 0), dtype=torch.uint8, device=f.device))
    return new, bases


def _top_beam(score):
    """Indices of the BEAM best options along dim 1, best first, ties by
    lower option index — lax.top_k's order. torch.topk does not promise
    stable ties (it returned [3, 5, 0] for [1,1,1,1,0,1], k=3), so this is
    a stable descending sort's prefix."""
    return torch.sort(score.to(torch.uint8), dim=1, descending=True,
                      stable=True).indices[:, :BEAM]


def _local_any(m) -> bool:
    return bool(m.any())


def resolve_ambiguous(cascade: BL.Cascade, fr: Frontier, cfg,
                      solid_fn=None, any_fn=_local_any) -> Frontier:
    """Re-arm walks retired on Bloom-fp branches via deep beam lookahead
    (see the reference's docstring): each solid candidate of an ambiguous
    step must keep a solid path of cfg.fp_lookahead more bases alive in a
    beam of BEAM paths; survivors resume with their base forced.

    Runs on a gathered frame of at most _resolve_cap(W) ambiguous lanes;
    with none ambiguous it returns the frontier unchanged (the reference
    computes the same no-op verdict). any_fn decides that test; a
    lane-sharded frontier passes one agreed over its ranks, so that every
    rank issues the routed probes or none does."""
    k = cfg.size_kmer
    if solid_fn is None:
        solid_fn = lambda chi, clo, m: BL.cascade_solid(cascade, chi,
                                                        clo, m, cfg)
    amb_all = (fr.end_kind == END_AMBIG) & ~fr.active
    if not any_fn(amb_all):
        return fr
    CAP = _resolve_cap(fr.forced.shape[0])
    # lax.top_k lane pick: ambiguous lanes first, ties by lower index
    lanes = torch.sort(amb_all.to(torch.uint8), descending=True,
                       stable=True).indices[:CAP]
    amb = amb_all[lanes]
    f = u2.pack(fr.fhi[lanes], fr.flo[lanes])
    r = u2.pack(fr.rhi[lanes], fr.rlo[lanes])
    # candidate frame [4, CAP]: the 4 right extensions in lockstep
    cand_f, cand_r = _Ext(k, f.device)(f, r)
    c = torch.minimum(cand_f, cand_r)
    first = solid_fn(c >> 32, c & M32, amb.expand(4, CAP))

    # beam state [4cand, BEAM, CAP]; slot 0 = the candidate, others dead
    cur_f = cand_f[:, None, :].expand(4, BEAM, CAP)
    cur_r = cand_r[:, None, :].expand(4, BEAM, CAP)
    alive = torch.zeros((4, BEAM, CAP), dtype=torch.bool, device=f.device)
    alive[:, 0] = first
    ext = _Ext(k, f.device, extra=2)
    for _ in range(int(cfg.fp_lookahead)):
        # children of every beam slot, option = child*BEAM + slot:
        # [4cand, 4*BEAM, CAP]
        of, orc = ext(cur_f[None], cur_r[None])   # [4child, 4, BEAM, CAP]
        of = of.transpose(0, 1).reshape(4, 4 * BEAM, CAP)
        orc = orc.transpose(0, 1).reshape(4, 4 * BEAM, CAP)
        c = torch.minimum(of, orc)
        s_opt = solid_fn(c >> 32, c & M32, alive.repeat(1, 4, 1))
        top = _top_beam(s_opt)                    # [4, BEAM, CAP]
        cur_f, cur_r = of.gather(1, top), orc.gather(1, top)
        alive = s_opt.gather(1, top)
    strong4 = (first & alive.any(dim=1)).T        # [CAP, 4]
    scnt = strong4.sum(-1)
    resolved = amb & (scnt == 1)
    if not cfg.break_on_deep_tie:
        # >=2 deep survivors: both paths real (see the reference)
        resolved = resolved | (amb & (scnt >= 2))
    return _scatter_resolved(fr, lanes, amb, resolved,
                             strong4.to(torch.uint8).argmax(-1))


# ---- wide (k > 31) frontier: four-word codes, fingerprint keys -------------


class FrontierW(NamedTuple):
    fwd: torch.Tensor         # [4, W] travel-frame forward code words
    rc: torch.Tensor          # [4, W]
    t0: torch.Tensor          # [4, W] start travel-frame code (circles)
    forced: torch.Tensor
    circle_ok: torch.Tensor
    active: torch.Tensor
    end_kind: torch.Tensor
    entry_slot: torch.Tensor
    steps: torch.Tensor


def make_frontier_wide(cwords, rcwords, dirs, forced, active,
                       circle_ok) -> FrontierW:
    """Seeds from canonical words [4, W] and their revcomp words; dirs as
    make_frontier's."""
    fwd = WD.wselect(dirs == 0, cwords, rcwords)
    rc = WD.wselect(dirs == 0, rcwords, cwords)
    n = fwd.shape[1]
    full = lambda v: torch.full((n,), v, dtype=torch.int64,
                                device=fwd.device)
    return FrontierW(
        fwd=fwd, rc=rc, t0=fwd, forced=forced.to(torch.int64),
        circle_ok=circle_ok.bool(), active=active.bool(),
        end_kind=full(RUNNING), entry_slot=full(-1), steps=full(0))


def _wide_children(f, r, k: int, lead: int):
    """The 4 right extensions of frames [4, *s] as [4 words, 4 bases,
    *s], with the canonical keys [4, *s] and orientation of each."""
    b = torch.arange(4, device=f.device).view((4,) + (1,) * lead)
    nf, nr = WD.right_ext_wide(f[:, None], r[:, None], b, k)
    c, cisf = WD.canon_of_wide(nf, nr)
    khi, klo = WD.fingerprint(c)
    return nf, nr, khi, klo, cisf


def walk_round_wide(cascade: BL.Cascade, junctions: T.Table, fr: FrontierW,
                    n_steps: int, cfg, junc_fn=None
                    ) -> Tuple[FrontierW, torch.Tensor]:
    """walk_round for four-word codes. The reference probes the 4 right
    extensions in 4 calls; here they are one [4, W] query (the same
    answers), and the new frame's key and orientation are taken from the
    chosen extension's instead of being hashed again."""
    k = cfg.size_kmer
    solid_fn = lambda chi, clo, m: BL.cascade_solid(cascade, chi, clo, m,
                                                    cfg)
    if junc_fn is None:
        junc_fn = lambda chi, clo, m: T.lookup(
            junctions, chi, clo, m, shard_bits=cfg.shard_bits)[0]
    f, r = fr.fwd, fr.rc
    active, end_kind = fr.active, fr.end_kind
    entry, steps = fr.entry_slot, fr.steps
    W = f.shape[1]
    outs = []
    for s in range(n_steps):
        a = active
        nf4, nr4, khi4, klo4, cisf4 = _wide_children(f, r, k, 1)
        solid4 = solid_fn(khi4, klo4, a.expand(4, W))   # [4, W]
        cnt = solid4.sum(0)
        free = a & (fr.forced < 0) if s == 0 else a
        dead = free & (cnt == 0)
        ambig = free & (cnt >= 2)
        bsel = solid4.to(torch.uint8).argmax(0)         # first solid base
        if s == 0:
            bsel = torch.where(fr.forced >= 0, fr.forced, bsel)
        advance = a & ~dead & ~ambig
        pbase = WD.wtop_base(f, k)
        pick = bsel[None]
        g = pick[None].expand(4, 1, W)
        f = torch.where(advance, nf4.gather(1, g)[:, 0], f)
        r = torch.where(advance, nr4.gather(1, g)[:, 0], r)
        circ = advance & fr.circle_ok & WD.weq(f, fr.t0)
        at_junc = junc_fn(khi4.gather(0, pick)[0], klo4.gather(0, pick)[0],
                          advance & ~circ)
        eslot = entry_slot(cisf4.gather(0, pick)[0], pbase)
        end_kind = torch.where(dead, END_DEAD, end_kind)
        end_kind = torch.where(ambig, END_AMBIG, end_kind)
        end_kind = torch.where(circ, END_CIRCULAR, end_kind)
        end_kind = torch.where(at_junc, END_JUNCTION, end_kind)
        entry = torch.where(at_junc, eslot, entry)
        active = advance & ~circ & ~at_junc
        outs.append(torch.where(advance, bsel, 255).to(torch.uint8))
        steps = steps + advance
    new = fr._replace(fwd=f, rc=r, forced=torch.full_like(fr.forced, -1),
                      active=active, end_kind=end_kind, entry_slot=entry,
                      steps=steps)
    bases = (torch.stack(outs, dim=1) if outs else
             torch.empty((W, 0), dtype=torch.uint8, device=f.device))
    return new, bases


def resolve_ambiguous_wide(cascade: BL.Cascade, fr: FrontierW, cfg
                           ) -> FrontierW:
    """Four-word twin of resolve_ambiguous: the same beam lookahead, lane
    compaction and tie order (_top_beam)."""
    k = cfg.size_kmer
    solid_fn = lambda chi, clo, m: BL.cascade_solid(cascade, chi, clo, m,
                                                    cfg)
    amb_all = (fr.end_kind == END_AMBIG) & ~fr.active
    if not bool(amb_all.any()):
        return fr
    CAP = _resolve_cap(fr.forced.shape[0])
    lanes = torch.sort(amb_all.to(torch.uint8), descending=True,
                       stable=True).indices[:CAP]
    amb = amb_all[lanes]
    # candidate frame [4 words, 4 cand, CAP]
    cand_f, cand_r, khi, klo, _ = _wide_children(fr.fwd[:, lanes],
                                                 fr.rc[:, lanes], k, 1)
    first = solid_fn(khi, klo, amb.expand(4, CAP))

    # beam state [4 words, 4 cand, BEAM, CAP]; slot 0 = the candidate
    cur_f = cand_f[:, :, None, :].expand(4, 4, BEAM, CAP)
    cur_r = cand_r[:, :, None, :].expand(4, 4, BEAM, CAP)
    alive = torch.zeros((4, BEAM, CAP), dtype=torch.bool, device=amb.device)
    alive[:, 0] = first
    for _ in range(int(cfg.fp_lookahead)):
        # children of every beam slot, option = child*BEAM + slot:
        # [4 words, 4 cand, 4*BEAM, CAP]
        of, orc, chi, clo, _ = _wide_children(cur_f, cur_r, k, 3)
        of = of.transpose(1, 2).reshape(4, 4, 4 * BEAM, CAP)
        orc = orc.transpose(1, 2).reshape(4, 4, 4 * BEAM, CAP)
        chi = chi.transpose(0, 1).reshape(4, 4 * BEAM, CAP)
        clo = clo.transpose(0, 1).reshape(4, 4 * BEAM, CAP)
        s_opt = solid_fn(chi, clo, alive.repeat(1, 4, 1))
        top = _top_beam(s_opt)                    # [4, BEAM, CAP]
        g = top[None].expand(4, 4, BEAM, CAP)
        cur_f, cur_r = of.gather(2, g), orc.gather(2, g)
        alive = s_opt.gather(1, top)
    strong4 = (first & alive.any(dim=1)).T        # [CAP, 4]
    scnt = strong4.sum(-1)
    resolved = amb & (scnt == 1)
    if not cfg.break_on_deep_tie:
        resolved = resolved | (amb & (scnt >= 2))  # see resolve_ambiguous
    return _scatter_resolved(fr, lanes, amb, resolved,
                             strong4.to(torch.uint8).argmax(-1))


def walk_waves(cascade: BL.Cascade, junctions: T.Table, fr, n_rounds: int,
               n_steps: int, cfg, walk_fn=None, resolve_fn=None,
               any_fn=_local_any):
    """Run up to n_rounds walk rounds (each n_steps, with fp-branch
    resolution between rounds), stopping early when no lane is pending.
    any_fn reduces the pending mask to the continue flag: a lane-sharded
    frontier (dist/swalk.py) passes one agreed over its ranks, or ranks
    would leave the loop at different rounds with their routed probes
    unanswered.

    Returns (frontier, bases u8[W, n_rounds*n_steps], rounds_executed);
    bases is 255 where no advance happened."""
    walk_fn = walk_fn or walk_round
    resolve_fn = resolve_fn or resolve_ambiguous

    def pending(fr):
        # active lanes OR ambiguous retirees the capped resolver has not
        # judged yet
        return any_fn(fr.active | (fr.end_kind == END_AMBIG))

    W = fr.steps.shape[0]
    bases = torch.full((W, n_rounds * n_steps), 255, dtype=torch.uint8,
                       device=fr.steps.device)
    r = 0
    while r < n_rounds and pending(fr):
        fr, b = walk_fn(cascade, junctions, fr, n_steps=n_steps, cfg=cfg)
        fr = resolve_fn(cascade, fr, cfg)
        bases[:, r * n_steps:(r + 1) * n_steps] = b
        r += 1
    return fr, bases, r
