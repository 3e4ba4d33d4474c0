"""Fixed-capacity all-to-all k-mer routing between ranks (port of
faucet_tpu/dist/route.py).

Items travel to the rank that owns their hash range in [n_shards, cap]
buckets, one `Mesh.all_to_all` per round. LOSSLESS: `route_consume` and
`route_query` run as many rounds as the most-loaded owner needs (round r
sends each owner the items ranked [r*cap, (r+1)*cap) among those still
pending), and every rank runs the same number of rounds, so no rank waits
on a collective another never issues and nothing is dropped however
skewed the owners are. Capacity is sized ~2x the mean at the call sites,
so one round is the common case.

The reference agrees on the round count with a `pmax` before its loop.
Here each rank's own count rides in one header row appended to every
bucket of the first round's buffer, and the ranks take the max of the
headers they receive: the same count, one collective fewer per route.
So a route whose items are all masked still makes one (empty) exchange
where the reference makes none; the received items, their order and the
answers are the reference's.

Bucket layout: an item's bucket is its owner, its slot the item's rank
among the pending items of that owner in lane order (`bucketize`: a
stable sort by owner, unmasked items keyed n_shards). So the order in
which an owner receives items, and so the order of its upserts, is the
reference's lane for lane. Payloads are dicts of integer tensors of
equal length (trailing dims allowed); they travel packed as the int64
columns of one buffer, with the pending flag as its last column.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from faucet_tpu_torch.dist.mesh import Mesh

I64 = torch.int64


class RouteInfo(NamedTuple):
    owner: torch.Tensor    # [n] destination rank per item (n_shards: none)
    rank: torch.Tensor     # [n] slot within the owner's bucket
    ok: torch.Tensor       # [n] bool: the item was sent
    dropped: torch.Tensor  # [] items over capacity


def bucketize(owner, mask, n_shards: int, cap: int) -> RouteInfo:
    """Assign each masked item an (owner, rank < cap) bucket slot."""
    n = owner.shape[0]
    key = torch.where(mask, owner.to(I64), n_shards)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    idx = torch.arange(n, device=owner.device)
    start = torch.ones((n,), dtype=torch.bool, device=owner.device)
    start[1:] = skey[1:] != skey[:-1]
    gstart = torch.cummax(torch.where(start, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - gstart
    ok = mask & (rank < cap)
    return RouteInfo(owner=key, rank=rank, ok=ok,
                     dropped=(mask & (rank >= cap)).sum())


def _slots(info: RouteInfo, n_shards: int, cap: int):
    """(row, col) of each item in an [n_shards + 1, cap] buffer; items not
    sent land in the spare row n_shards, which is never sent."""
    return (torch.where(info.ok, info.owner, n_shards),
            torch.clamp(info.rank, max=cap - 1))


def _pack(payload: Dict[str, torch.Tensor], pending) -> torch.Tensor:
    cols = [v.reshape(v.shape[0], -1).to(I64) for v in payload.values()]
    return torch.cat(cols + [pending.to(I64)[:, None]], dim=1)


def _unpack(payload, rows) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """_pack's inverse: contiguous tensors in the payload's dtypes."""
    out, c = {}, 0
    for name, v in payload.items():
        w = math.prod(v.shape[1:])
        out[name] = rows[:, c:c + w].reshape(
            (rows.shape[0],) + v.shape[1:]).to(v.dtype).contiguous()
        c += w
    return out, rows[:, c] > 0


def _round_send(mesh: Mesh, payload, pending, owner, n_shards: int,
                cap: int, local_rounds: int = 0):
    """One all_to_all round over the pending items. Returns (received
    payload [n_shards*cap], received mask, RouteInfo, the max over ranks
    of `local_rounds`)."""
    info = bucketize(owner, pending, n_shards, cap)
    rows = _pack(payload, pending)
    buf = torch.zeros((n_shards + 1, cap + 1, rows.shape[1]), dtype=I64,
                      device=rows.device)
    row, col = _slots(info, n_shards, cap)
    buf[row, col] = torch.where(info.ok[:, None], rows, 0)
    buf[:n_shards, cap, 0] = local_rounds     # the header row
    recv = mesh.all_to_all(buf[:n_shards])
    rounds = int(recv[:, cap, 0].max())
    out, rmask = _unpack(payload, recv[:, :cap].reshape(n_shards * cap, -1))
    return out, rmask, info, rounds


def _local_rounds(owner, mask, n_shards: int, cap: int) -> int:
    """ceil(most items bound for one owner / cap), on this rank."""
    counts = torch.bincount(owner[mask].to(I64), minlength=n_shards)
    return -(-int(counts.max()) // cap) if counts.numel() else 0


def route(mesh: Mesh, payload: Dict[str, torch.Tensor], owner, mask,
          n_shards: int, cap: int):
    """One-shot send of each masked item to its owner (items past cap are
    dropped and counted). Returns (received payload [n_shards*cap],
    received mask, RouteInfo for route_back)."""
    out, rmask, info, _ = _round_send(mesh, payload, mask, owner, n_shards,
                                      cap)
    return out, rmask, info


def route_consume(mesh: Mesh, payload: Dict[str, torch.Tensor], owner, mask,
                  n_shards: int, cap: int, consume: Callable, state):
    """LOSSLESS owner routing for inserts: rounds of all_to_all until every
    masked item is delivered, each round's received items folded into
    `state` by consume(state, recv, recv_mask). Returns (state, n_unsent),
    n_unsent 0 by construction (a tested invariant)."""
    local = _local_rounds(owner, mask, n_shards, cap)
    pending, r, rounds = mask, 0, 1
    while r < rounds:
        recv, rmask, info, agreed = _round_send(mesh, payload, pending,
                                                owner, n_shards, cap, local)
        if r == 0:
            rounds = max(agreed, 1)
            mesh.stats["carry_rounds"] += rounds - 1
        state = consume(state, recv, rmask)
        pending = pending & ~info.ok
        r += 1
    return state, pending.sum()


def route_query(mesh: Mesh, payload: Dict[str, torch.Tensor], owner, mask,
                n_shards: int, cap: int, answer: Callable,
                ans_dtype=torch.int8, fill=0):
    """LOSSLESS owner-routed query: every masked item reaches its owner,
    is answered there by answer(recv, recv_mask) -> [n_shards*cap], and
    the answer returns to the item's lane. Returns ([n] answers, `fill`
    where unmasked; n_unsent == 0)."""
    n = owner.shape[0]
    got = torch.full((n,), fill, dtype=ans_dtype, device=owner.device)
    local = _local_rounds(owner, mask, n_shards, cap)
    pending, r, rounds = mask, 0, 1
    while r < rounds:
        recv, rmask, info, agreed = _round_send(mesh, payload, pending,
                                                owner, n_shards, cap, local)
        if r == 0:
            rounds = max(agreed, 1)
            mesh.stats["carry_rounds"] += rounds - 1
        ans = answer(recv, rmask).to(ans_dtype)
        back = route_back(mesh, ans, info, n_shards, cap, fill=fill)
        got = torch.where(info.ok, back, got)
        pending = pending & ~info.ok
        r += 1
    return got, pending.sum()


def route_back(mesh: Mesh, answers, info: RouteInfo, n_shards: int,
               cap: int, fill=0):
    """Return per-received-item answers ([n_shards*cap, ...], aligned
    with the received layout) to the lanes that asked; `fill` where an
    item was not sent."""
    tail = answers.shape[1:]
    back = mesh.all_to_all(answers.reshape((n_shards, cap) + tail))
    spare = torch.full((1, cap) + tail, fill, dtype=back.dtype,
                       device=back.device)
    row, col = _slots(info, n_shards, cap)
    return torch.cat([back, spare])[row, col]
