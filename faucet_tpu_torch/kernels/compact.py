"""Stream compaction: indices of the set lanes of a mask
(port of faucet_tpu/kernels/compact.py).

`mask_indices(mask, cap)` returns (idx, count): idx int64[cap] holds the
indices of the first min(count, cap) set lanes in lane order, and count
(an int64 0-d tensor, on the mask's device) is the TOTAL number of set
lanes, which may exceed cap. Slots at or past min(count, cap) are
don't-care, as in the reference; callers mask by arange(cap) < count.

CUDA tensors launch the single-pass kernel of csrc/compact.cu (one launch,
no host sync), CPU tensors take the plain torch version (kernels/build.py
has the one boundary of every kernel entry). The kernel's look-back
scratch (a ticket counter and one status word per 4,096-lane tile) is
kept across calls per device and stream and grows with the mask; every
call bumps the scratch's epoch instead of clearing it. Two streams never
share a scratch.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.kernels import build as KB

TILE = 4096           # mask lanes per tile (csrc/compact.cu FT_CP_TILE)
EPOCH_LIMIT = 1 << 30  # epochs are 30 bits in a status word
MAX_LANES = (1 << 31) - 16

# (device, stream) -> [int64[1 + tiles] scratch, epoch of the last call]
_scratch = {}


def mask_indices_plain(mask, cap: int):
    """Plain torch version of `mask_indices` (any device)."""
    nz = torch.nonzero(mask).squeeze(1)
    idx = torch.zeros((cap,), dtype=torch.int64, device=mask.device)
    m = min(cap, nz.shape[0])
    idx[:m] = nz[:m]
    return idx, torch.tensor(nz.shape[0], dtype=torch.int64,
                             device=mask.device)


def _epoch(device, stream: int, tiles: int):
    """(scratch, epoch) for a call of `tiles` tiles: the scratch is zeroed
    when it is made or grown, and when the epoch would wrap, so no status
    word of an earlier call can carry this call's epoch."""
    st = _scratch.get((device, stream))
    if st is None or st[0].shape[0] - 1 < tiles:
        st = [torch.zeros((1 + max(tiles, 256),), dtype=torch.int64,
                          device=device), 0]
        _scratch[(device, stream)] = st
    st[1] += 1
    if st[1] >= EPOCH_LIMIT:
        st[0].zero_()
        st[1] = 1
    return st[0], st[1]


def launch(mask, idx, total):
    """One launch of the kernel into preallocated idx (int64[cap]) and
    total (int64, one element), counted as `compact_launches`
    (chip_smoke.py times the kernel alone with it)."""
    n = mask.shape[0]
    tiles = max(1, -(-(n + mask.data_ptr() % 16) // TILE))
    stream = KB.stream_of(mask)
    scratch, epoch = _epoch(mask.device, stream, tiles)
    KB.launch("mask_indices", "compact_launches", mask.data_ptr(), n,
              idx.data_ptr(), idx.shape[0], total.data_ptr(),
              scratch.data_ptr(), scratch.shape[0] - 1, epoch, stream,
              # a launch that failed may leave the ticket counter set
              on_fail=lambda: _scratch.pop((mask.device, stream)))


def mask_indices(mask, cap: int):
    """Indices of the True lanes of bool[N] `mask`, first `cap` in lane
    order, and the total count (no host sync)."""
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError(f"mask: expected bool[N], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if cap < 0 or mask.shape[0] > MAX_LANES:
        raise ValueError(f"cap {cap}, {mask.shape[0]} lanes: need cap >= 0 "
                         f"and at most {MAX_LANES} lanes")
    if not mask.is_cuda:
        return mask_indices_plain(mask, cap)
    KB.on_card(("mask", mask))
    out = torch.empty((cap + 1,), dtype=torch.int64, device=mask.device)
    idx, total = out[:cap], out[cap]
    launch(mask, idx, total)
    return idx, total
