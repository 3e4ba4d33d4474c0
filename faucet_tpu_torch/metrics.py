"""Counters, spans and blocking device reads of a run.

After faucet_tpu/metrics.py, which prints phase counters and wall-clock
to stderr and a JSONL file (`--metrics_file`); `emit` keeps that output
and adds the port's own records:

- `counters`: the work done (reads, junctions, contigs, cleaning), the
  same keys and values as the reference's. `add` takes a host number or
  a device tensor; a tensor is summed on the device and read once, when
  `counters` is read (by `emit`), so counting never waits on the device.
- `tally`: how the port drove the device, which the reference has no
  counterpart of: `host_syncs` (blocking reads, one per `fetch`),
  `table_probe_rounds` (probe rounds issued from the host: the CPU's
  torch rounds; on the card a table upsert is one launch, counted in
  `upsert_launches`), `walk_rounds`, `walk_steps`, `pass2_seeds` and
  `pass2_dups` (the graph build's pass-2 sink anchors walked and
  contigs dropped as near-duplicates), `node_keys` (lanes handed to the
  branch-node cascade's insert), `spool_flushes` and
  `<kernel>_launches` for each kernel entry, counted by kernels/build.py
  `launch`: `probe`, `cascade` (and by the reference's variant,
  `cascade_dense`, `cascade_sparse`, `cascade_multi_tile`),
  `bloom_insert_codes`, `scatter_or_bits`, `compact`, `wide_ext` and
  `upsert`.
- `timers`: seconds per span path. `with m.span("scan"):` times a stretch
  of host code; spans nest on a per-thread stack and the timer key is the
  path of the enclosing spans' names joined by "/" (`build/pass1/walk/
  round`), so a path's seconds include its children's. While
  torch.profiler records, a span is also a `record_function` named
  "faucet." + its path: the Chrome trace of `--profile` and any profiled
  slice show what the host was doing, on the device's clock. A span
  never synchronizes.

Code below the Pipeline reaches the Metrics of the innermost open span
through the module-level `span`, `fetch` and `count` (the process default
when none is open, as in tests that call core/ directly).
"""
from __future__ import annotations

import json
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

_local = threading.local()
TALLY_SLOTS = 64  # device tally keys of a Metrics (one 512-byte block)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


# whether torch.profiler records on this thread
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("metrics", "name", "path", "t0", "rf")

    def __init__(self, metrics: "Metrics", name: str):
        self.metrics, self.name = metrics, name

    def __enter__(self):
        st = _stack()
        self.path = f"{st[-1].path}/{self.name}" if st else self.name
        st.append(self)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function("faucet." + self.path)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        t = self.metrics.timers
        t[self.path] = t.get(self.path, 0.0) + dt
        return False


class Metrics:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.path = jsonl_path
        self._counters: Dict[str, float] = {}
        self._device: Dict[str, torch.Tensor] = {}  # unread device sums
        # the tally's device counts: one int64 buffer, a slot a key
        self._tally_buf: Optional[torch.Tensor] = None
        self._tally_slots: Dict[str, int] = {}
        self.tally: Dict[str, int] = {}
        self.timers: Dict[str, float] = {}

    def add(self, key: str, val=1):
        """Add a host number, or a device tensor (summed on the device)."""
        if isinstance(val, torch.Tensor):
            cur = self._device.get(key)
            if cur is None:
                self._device[key] = val.detach().to(torch.int64, copy=True)
            else:
                cur.add_(val)
        else:
            self._counters[key] = self._counters.get(key, 0) + val

    def on_device(self, key: str, device) -> torch.Tensor:
        """The int64 0-d tensor on `device` that a kernel adds its count
        of tally `key` into, in place: no launch and no read of its own;
        it joins the tally when `counters` is read. The keys share one
        buffer of TALLY_SLOTS (one allocation)."""
        if self._tally_buf is None:
            self._tally_buf = torch.zeros((TALLY_SLOTS,), dtype=torch.int64,
                                          device=device)
        slot = self._tally_slots.get(key)
        if slot is None:
            slot = len(self._tally_slots)
            if slot == TALLY_SLOTS:
                raise ValueError(f"more than {TALLY_SLOTS} device tally "
                                 "keys")
            self._tally_slots[key] = slot
        return self._tally_buf[slot]

    @property
    def counters(self) -> Dict[str, float]:
        """Every counter as a host number: the device sums, and the
        tally's device counts, are read here, in one fetch."""
        sums = [(self._counters, k, v) for k, v in self._device.items()] \
            + [(self.tally, k, self._tally_buf[i])
               for k, i in self._tally_slots.items()]
        if sums:
            vals = self.fetch(torch.stack([v for _, _, v in sums]))
            self._device, self._tally_buf, self._tally_slots = {}, None, {}
            for (into, k, _), v in zip(sums, vals.tolist()):
                into[k] = into.get(k, 0) + v
        return self._counters

    def count(self, key: str, n: int = 1):
        self.tally[key] = self.tally.get(key, 0) + n

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def fetch(self, x: torch.Tensor) -> np.ndarray:
        """x on the host, as numpy: a blocking read (span `sync`, counted
        in `host_syncs`). Callers take int(), bool() or .tolist() of it."""
        with self.span("sync"):
            out = x.detach().cpu().numpy()
        self.count("host_syncs")
        return out

    def emit(self, event: str, **extra):
        counters = self.counters
        rec = {"event": event, "ts": time.time(),
               "counters": dict(counters), "tally": dict(self.tally),
               "timers_s": {k: round(v, 4) for k, v in self.timers.items()},
               **extra}
        print(f"[faucet_tpu] {event}: " + ", ".join(
            f"{k}={v}" for k, v in sorted({**counters,
                                           **self.tally}.items())),
            file=sys.stderr)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


_default = Metrics()


def current() -> Metrics:
    """The Metrics of the innermost open span on this thread, else the
    process default."""
    st = _stack()
    return st[-1].metrics if st else _default


def span(name: str) -> _Span:
    return current().span(name)


def fetch(x: torch.Tensor) -> np.ndarray:
    return current().fetch(x)


def count(key: str, n: int = 1):
    current().count(key, n)
