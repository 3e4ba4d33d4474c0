"""Peaks of the card, the roofline bound, and the bytes and operations
the two main-path kernels need per call, counted from the call's inputs.

Copied from chip_smoke.py (`bound`, HBM_BYTES_PER_S, ALU_OPS_PER_S,
HASH_OPS, BIT_OPS and the byte counts of `check_probe` and
`_cascade_case`): each input read once and each output written once,
whatever implements the call. A filter block (512 bits, 64 bytes) counts
once per call however many lanes touch it.

`Recorder` wraps the two kernel entries of the port while a profiled
slice runs, keeping each call's inputs and outputs (held, not copied, so
the slice has no extra device work); the counts are made after the slice.
"""
from __future__ import annotations

import torch

from benchmark import reference as R

# NVIDIA H100 SXM data sheet, at the 700 W limit: HBM bytes per second,
# and 32-bit integer operations per second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# integer instructions per key of the fused hashing (two fmix32 chains,
# block and rotation) and per probe bit (address, selects, test)
HASH_OPS, BIT_OPS = 40, 20
SENTINEL = 0xFFFFFFFF

# the device kernels that implement each entry (csrc/probe.cu,
# csrc/cascade.cu)
KERNELS = {"probe": ("ft_contains_kernel",),
           "cascade": ("ft_cascade_count_kernel", "ft_cascade_apply_kernel",
                       "ft_cascade_clear_kernel")}


def bound_s(nbytes: float, nops: float) -> float:
    """The least time: the larger of bytes over the HBM rate and
    operations over the integer rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ALU_OPS_PER_S)


def _blocks(khi, klo, log2_bits: int) -> int:
    """Distinct 512-bit blocks the keys address."""
    h1, _ = R.hash_pair(khi, klo)
    return int(torch.unique(h1 & ((1 << (log2_bits - 9)) - 1)).numel())


def probe_counts(n: int, mask_numel: int, n_live: int, n_blocks: int,
                 n_hash: int):
    """(bytes, ops) of one membership call: the mask, the live codes
    (two int64 words), the result, and each touched block."""
    return (mask_numel + 16 * n_live + n + 64 * n_blocks,
            n_live * (HASH_OPS + BIT_OPS * n_hash))


def cascade_counts(n: int, n_live: int, touched: int, changed: int,
                   n_hash_a: int, n_hash_b: int):
    """(bytes, ops) of one cascade insert: mask and two flags per lane,
    the live codes, each touched block of A and B read once and each
    changed block written once."""
    return (3 * n + 16 * n_live + 64 * (touched + changed),
            n_live * (HASH_OPS + BIT_OPS * (n_hash_a + n_hash_b)))


class Recorder:
    """Records calls of kernels/probe.py bloom_contains_codes and
    kernels/cascade.py cascade_insert while `on` is set."""

    def __init__(self):
        from faucet_tpu_torch.kernels import cascade as KC
        from faucet_tpu_torch.kernels import probe as KP

        self.on = False
        self.calls = {"probe": [], "cascade": []}
        self._mods = ((KP, "bloom_contains_codes", "probe"),
                      (KC, "cascade_insert", "cascade"))
        self._orig = {}
        for mod, name, kind in self._mods:
            orig = getattr(mod, name)
            self._orig[kind] = orig
            setattr(mod, name, self._wrap(orig, kind))

    def _wrap(self, orig, kind):
        def call(*a, **kw):
            out = orig(*a, **kw)
            if self.on:
                self.calls[kind].append((a, out))
            return out
        return call

    def close(self):
        for mod, name, kind in self._mods:
            setattr(mod, name, self._orig[kind])

    def bounds(self) -> dict:
        """{kind: (summed least seconds, calls)} of the recorded calls."""
        if getattr(self, "_bounds", None) is None:
            self._bounds = self._count()
        return self._bounds

    def _count(self) -> dict:
        out = {}
        tot = 0.0
        for (words, khi, klo, mask, nh, log2, *_), _ in self.calls["probe"]:
            live = mask.expand(khi.shape)
            tot += bound_s(*probe_counts(
                khi.numel(), mask.numel(), int(live.sum()),
                _blocks(khi[live], klo[live], log2), nh))
        out["probe"] = (tot, len(self.calls["probe"]))
        tot = 0.0
        for args, (new_b, solid) in self.calls["cascade"]:
            a_w, b_w, khi, klo, mask, la, lb, _sb, nha, nhb = args[:10]
            live = mask & (khi != SENTINEL)
            fresh = live & ~solid
            touched = (_blocks(khi[live], klo[live], la)
                       + _blocks(khi[live], klo[live], lb))
            changed = (_blocks(khi[fresh], klo[fresh], la)
                       + _blocks(khi[new_b], klo[new_b], lb))
            tot += bound_s(*cascade_counts(khi.numel(), int(live.sum()),
                                           touched, changed, nha, nhb))
        out["cascade"] = (tot, len(self.calls["cascade"]))
        return out


def device_seconds(device_events, kind: str):
    """(summed seconds, launches) of a kind's kernels among a slice's
    device events (start_ns, end_ns, name)."""
    hits = [(e - s) for s, e, n in device_events
            if any(k in n for k in KERNELS[kind])]
    return sum(hits) / 1e9, len(hits)
