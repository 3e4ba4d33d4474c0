"""Tagged branch-node keys: junction detection without 8-way probes.

Port of faucet_tpu/core/nodes.py (see its docstring for the derivation).
A solid k-mer is an edge between its prefix and suffix (k-1)-mer nodes;
the key (canonical (k-1)-mer, position XOR orientation) of an edge
endpoint does not depend on the strand it is computed from. During the
load pass every k-mer first promoted into B inserts its two endpoint
keys into the node cascade D -> E; E then holds the branching node-sides,
and the scan's junction test is two E-probes per window.
Palindromic nodes force side 0 (over-detection only).
"""
from __future__ import annotations

from typing import Tuple

import torch

from faucet_tpu_torch.core import u32x2 as u2

SIDE_BIT = 30  # tag bit in key_hi; code bits stay below 2*31-32


def _node_views(chi, clo, ohi, olo, k: int):
    """Both (k-1)-nodes of a k-mer given its canonical (chi, clo) and
    reverse-complement (ohi, olo) codes: (prefix_fwd, prefix_rc,
    suffix_fwd, suffix_rc), each an (hi, lo) pair."""
    nb = 2 * (k - 1)
    p_fwd = u2.shr2(chi, clo)
    p_rc = u2.mask_bits(ohi, olo, nb)
    s_fwd = u2.mask_bits(chi, clo, nb)
    s_rc = u2.shr2(ohi, olo)
    return p_fwd, p_rc, s_fwd, s_rc


def _tagged(n_fwd, n_rc, pos_is_suffix: bool):
    """Orientation-invariant endpoint key for a node occurrence."""
    fh, fl = n_fwd
    rh, rl = n_rc
    as_canon = u2.le(fh, fl, rh, rl)   # o = 0 when as-seen is canonical
    pal = u2.eq(fh, fl, rh, rl)
    khi, klo = u2.select(as_canon, fh, fl, rh, rl)
    side = (as_canon if pos_is_suffix else ~as_canon) & ~pal
    return khi | (side.to(torch.int64) << SIDE_BIT), klo


def endpoint_keys(chi, clo, ohi, olo, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """The two endpoint keys a solid k-mer contributes on promotion:
    (pk_hi, pk_lo, sk_hi, sk_lo), prefix node (pos=0) then suffix (pos=1)."""
    p_fwd, p_rc, s_fwd, s_rc = _node_views(chi, clo, ohi, olo, k)
    pk_hi, pk_lo = _tagged(p_fwd, p_rc, pos_is_suffix=False)
    sk_hi, sk_lo = _tagged(s_fwd, s_rc, pos_is_suffix=True)
    return pk_hi, pk_lo, sk_hi, sk_lo


def probe_keys(chi, clo, ohi, olo, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          torch.Tensor, torch.Tensor]:
    """The two branch queries of a window: (rk_hi, rk_lo, lk_hi, lk_lo).
    Right branch: out-edges of the suffix node (they see it as PREFIX,
    pos=0); left branch: in-edges of the prefix node (pos=1)."""
    p_fwd, p_rc, s_fwd, s_rc = _node_views(chi, clo, ohi, olo, k)
    rk_hi, rk_lo = _tagged(s_fwd, s_rc, pos_is_suffix=False)
    lk_hi, lk_lo = _tagged(p_fwd, p_rc, pos_is_suffix=True)
    return rk_hi, rk_lo, lk_hi, lk_lo
