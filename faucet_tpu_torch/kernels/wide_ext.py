"""The eight extension keys of wide k-mer windows (31 < k <= 63).

`slot_ext_keys(canon, other, k)` gives the fingerprint keys of each
window's eight one-base extensions in its canonical frame: (his, los),
int64 [..., 8], slots 0-3 the right extensions by base 0-3, slots 4-7 the
left ones; each the canonical form's fingerprint (hi & 0x3FFFFFFF, lo).
For CUDA tensors it is ONE launch of the hand-written kernel
csrc/wide_ext.cu, which holds each window's code in registers; CPU
tensors take the plain torch version, `slot_ext_keys_plain`
(kernels/build.py has the one boundary of every kernel entry). The
kernel replaces no Pallas kernel: the reference computes these keys as
XLA-fused jnp (faucet_tpu/core/wide.py slot_ext_keys_wide).

Argument types: canon and other int64 [4, ...] holding uint32 words, word
0 first (core/wide.py's layout): each window's canonical code and its
reverse complement.
"""
from __future__ import annotations

import torch

from faucet_tpu_torch.core import wide as WD
from faucet_tpu_torch.kernels import build as KB

NW = WD.NW  # words per wide code


def slot_ext_keys_plain(canon, other, k: int):
    """Plain torch version of `slot_ext_keys` (any device). Built one
    extension at a time into the stacked grid, so only one extension's
    intermediates are alive at once."""
    shape = canon.shape[1:] + (8,)
    his = torch.empty(shape, dtype=torch.int64, device=canon.device)
    los = torch.empty_like(his)
    for s in range(8):
        ext = WD.right_ext_wide if s < 4 else WD.left_ext_wide
        c, _ = WD.canon_of_wide(*ext(canon, other, s % 4, k))
        his[..., s], los[..., s] = WD.fingerprint(c)
    return his, los


def slot_ext_keys(canon, other, k: int):
    """Fingerprint keys of the 8 slot-extensions of each window."""
    if not 31 < k <= 63:
        raise ValueError(f"k = {k}: wide codes take 31 < k <= 63")
    if canon.dim() < 1 or canon.shape[0] != NW:
        raise ValueError(f"canon: expected [{NW}, ...] words, got "
                         f"{tuple(canon.shape)}")
    KB.lanes(canon, ("canon", canon, torch.int64),
             ("other", other, torch.int64))
    if not canon.is_cuda:
        return slot_ext_keys_plain(canon, other, k)
    canon, other = canon.contiguous(), other.contiguous()
    KB.on_card(("canon", canon), ("other", other))
    his = torch.empty(canon.shape[1:] + (8,), dtype=torch.int64,
                      device=canon.device)
    los = torch.empty_like(his)
    n = his.numel() // 8
    if n == 0:
        return his, los
    KB.launch("wide_ext_keys", "wide_ext_launches", canon.data_ptr(),
              other.data_ptr(), n, k, his.data_ptr(), los.data_ptr(),
              KB.stream_of(canon))
    return his, los
