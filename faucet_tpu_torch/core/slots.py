"""Slot conventions for junction nodes (port of faucet_tpu/core/slots.py).

slot s in 0..3: RIGHT extension — append base s to the canonical form.
slot s in 4..7: LEFT  extension — prepend base s-4 to the canonical form.
Walks starting at slot s < 4 travel in canonical orientation; s >= 4
travel in the reverse complement, first appended base 3 - (s - 4).

Each helper takes python scalars (the host graph cleaner) or tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def exit_slot(canon_is_fwd, next_base):
    """Slot of the edge a rightward-traveling read uses to LEAVE a node."""
    if isinstance(canon_is_fwd, (bool, np.bool_)):
        return int(next_base) if canon_is_fwd else 4 + (3 - int(next_base))
    return torch.where(canon_is_fwd, next_base, 7 - next_base)


def entry_slot(canon_is_fwd, prev_base):
    """Slot of the edge a rightward-traveling read used to ENTER a node."""
    if isinstance(canon_is_fwd, (bool, np.bool_)):
        return 4 + int(prev_base) if canon_is_fwd else 3 - int(prev_base)
    return torch.where(canon_is_fwd, 4 + prev_base, 3 - prev_base)


def opposite_side(slot):
    """True if slot is a left slot (4..7)."""
    return slot >= 4


def slot_base(slot):
    """The base appended/prepended by a slot, in canonical frame."""
    if isinstance(slot, (int, np.integer)):
        return slot if slot < 4 else slot - 4
    return torch.where(slot < 4, slot, slot - 4)
