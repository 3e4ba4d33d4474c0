"""Stream compaction: indices of the set lanes of a mask
(port of faucet_tpu/kernels/compact.py).

`mask_indices(mask, cap)` returns (idx, count): idx int64[cap] holds the
indices of the first min(count, cap) set lanes in lane order, and count
(an int64 0-d tensor, on the mask's device) is the TOTAL number of set
lanes, which may exceed cap. Slots at or past min(count, cap) are
don't-care, as in the reference; callers mask by arange(cap) < count.

CUDA tensors launch the three-pass kernel of csrc/compact.cu, CPU tensors
take the plain torch version; nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.kernels import build as KB

# kernel launches by mask_indices (reset and read by chip_smoke.py)
launches = 0
_chunk = None  # mask lanes per CUDA block (csrc/compact.cu FT_CP_CHUNK)


def mask_indices_plain(mask, cap: int):
    """Plain torch version of `mask_indices` (any device)."""
    nz = torch.nonzero(mask).squeeze(1)
    idx = torch.zeros((cap,), dtype=torch.int64, device=mask.device)
    m = min(cap, nz.shape[0])
    idx[:m] = nz[:m]
    return idx, torch.tensor(nz.shape[0], dtype=torch.int64,
                             device=mask.device)


def mask_indices(mask, cap: int):
    """Indices of the True lanes of bool[N] `mask`, first `cap` in lane
    order, and the total count (no host sync)."""
    global launches, _chunk
    if not mask.is_cuda:
        return mask_indices_plain(mask, cap)
    KB.require_cuda("mask", mask, torch.bool)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    lib = KB.library()
    if _chunk is None:
        _chunk = int(lib.ft_mask_indices_chunk())
    n = mask.shape[0]
    idx = torch.empty((cap,), dtype=torch.int64, device=mask.device)
    total = torch.empty((), dtype=torch.int64, device=mask.device)
    scratch = torch.empty((max(1, -(-n // _chunk)),), dtype=torch.int64,
                          device=mask.device)
    KB.check(lib.ft_mask_indices(mask.data_ptr(), n, idx.data_ptr(), cap,
                                 total.data_ptr(), scratch.data_ptr(),
                                 KB.stream_of(mask)), "mask_indices")
    launches += 1
    return idx, total
