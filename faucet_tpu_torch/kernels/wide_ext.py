"""The eight extension keys of wide k-mer windows (31 < k <= 63).

`slot_ext_keys(canon, other, k)` gives the fingerprint keys of each
window's eight one-base extensions in its canonical frame: (his, los),
int64 [..., 8], slots 0-3 the right extensions by base 0-3, slots 4-7 the
left ones; each the canonical form's fingerprint (hi & 0x3FFFFFFF, lo).
For CUDA tensors it is ONE launch of the hand-written kernel
csrc/wide_ext.cu, which holds each window's code in registers; CPU
tensors take the plain torch version, core/wide.py
`slot_ext_keys_wide_plain`. Nothing falls back from one to the other.
The kernel replaces no Pallas kernel: the reference computes these keys
as XLA-fused jnp (faucet_tpu/core/wide.py slot_ext_keys_wide).

Argument types: canon and other int64 [4, ...] holding uint32 words, word
0 first (core/wide.py's layout): each window's canonical code and its
reverse complement.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch import metrics as M
from faucet_tpu_torch.kernels import build as KB

NW = 4  # words per wide code

# kernel launches by slot_ext_keys (reset and read by tests)
launches = 0


def slot_ext_keys(canon, other, k: int):
    """Fingerprint keys of the 8 slot-extensions of each window."""
    global launches
    if not 31 < k <= 63:
        raise ValueError(f"k = {k}: wide codes take 31 < k <= 63")
    for name, t in (("canon", canon), ("other", other)):
        if t.dtype != torch.int64:
            raise ValueError(f"{name}: expected torch.int64, got {t.dtype}")
        if t.dim() < 1 or t.shape[0] != NW:
            raise ValueError(f"{name}: expected [{NW}, ...] words, got "
                             f"{tuple(t.shape)}")
    if other.shape != canon.shape:
        raise ValueError("canon, other: shape mismatch")
    if other.device != canon.device:
        raise ValueError("canon, other: device mismatch")
    if not canon.is_cuda:
        from faucet_tpu_torch.core import wide as WD

        return WD.slot_ext_keys_wide_plain(canon, other, k)
    canon, other = canon.contiguous(), other.contiguous()
    his = torch.empty(canon.shape[1:] + (8,), dtype=torch.int64,
                      device=canon.device)
    los = torch.empty_like(his)
    n = his.numel() // 8
    if n == 0:
        return his, los
    KB.check(KB.library().ft_wide_ext_keys(
        canon.data_ptr(), other.data_ptr(), n, k, his.data_ptr(),
        los.data_ptr(), KB.stream_of(canon)), "wide_ext_keys")
    launches += 1
    M.count("wide_ext_launches")
    return his, los
