"""Profiler slices and what the per-layer metrics read from them.

A traced run profiles a few bounded slices of its window with
torch.profiler (CPU and CUDA activity), never the whole window, so the
trace stays small. From each slice it keeps the device operations'
intervals, the benchmark's own spans (record_function labels around the
calls it drives) and the host's operations, and sums them up: busy time
as the union of device intervals, launches, seconds by kernel name, and
the idle gaps named by the span and host operation they fall in.

`walk_timer` is chip_smoke.py's `_walk_timer` (one synchronize per walk
round); the busy share follows chip_smoke.py's `device_share`, with the
union of intervals in place of the sum of kernel times.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

SPAN = "bench."  # prefix of the benchmark's own spans


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Slices:
    """Accumulates profiled slices: `with slices.slice(): ...`."""

    def __init__(self):
        self.device: List[tuple] = []   # (start_ns, end_ns, name)
        self.host: List[tuple] = []     # (start_ns, end_ns, name)
        self.window_s = 0.0
        self.windows: List[tuple] = []  # (start_ns, end_ns) per slice
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        sync()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()
        self._ns0 = time.time_ns()

    def stop(self):
        sync()
        self.window_s += time.perf_counter() - self._t0
        ns1 = time.time_ns()
        self._prof.stop()
        self.windows.append((self._ns0, ns1))
        for e in self._prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                self.host.append(rec)
            elif not (e.is_user_annotation() or rec[2].startswith(SPAN)):
                # a span's mirror on the device timeline is no operation
                self.device.append(rec)
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def busy_intervals(self) -> List[tuple]:
        """The union of the device intervals, sorted."""
        out: List[list] = []
        for s, e, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def launches(self) -> int:
        return len(self.device)

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, n in self.device:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def gaps(self) -> List[tuple]:
        """(start_ns, end_ns) of each idle stretch of every slice: between
        its start, its device intervals and its end."""
        busy = self.busy_intervals()
        out = []
        for w0, w1 in self.windows:
            t = w0
            for s, e in busy:
                if e <= w0 or s >= w1:
                    continue
                if s > t:
                    out.append((t, s))
                t = max(t, e)
            if w1 > t:
                out.append((t, w1))
        return out

    def _doing(self, t: int) -> str:
        """The innermost benchmark span, and the innermost host operation
        inside it, that cover host time t."""
        cover = [(e - s, n) for s, e, n in self.host if s <= t < e]
        spans = sorted(x for x in cover if x[1].startswith(SPAN))
        ops = sorted(x for x in cover if not x[1].startswith(SPAN))
        span = spans[0][1][len(SPAN):] if spans else "outside spans"
        return f"{span}: {ops[0][1]}" if ops else span

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10
        longest idle gaps, each named by what the host was doing."""
        ops = sorted(self.seconds_by_name().items(), key=lambda x: -x[1])
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops[:10]],
                "idle_gaps": [[self._doing((a + b) // 2)[:120],
                               (b - a) / 1e9] for a, b in gaps]}


def walk_timer(module, name: str, stats: dict, profile_rounds=(),
               slices: Slices = None):
    """Wrap `module.<name>` (graph/walk.py's walk_round or
    walk_round_wide; the graph builder looks it up per call) to count
    rounds and steps and time each round, closed by a synchronize. The
    rounds numbered in profile_rounds (counted from 1 over the process)
    run inside a profiled slice instead and count apart. Returns the
    original function, to put back."""
    orig = getattr(module, name)

    def timed(cascade, junctions, fr, n_steps, cfg, **kw):
        stats["rounds"] = stats.get("rounds", 0) + 1
        r = stats["rounds"]
        if r in profile_rounds:
            if not slices.active:
                slices.start()
            with torch.profiler.record_function(SPAN + "walk_round"):
                out = orig(cascade, junctions, fr, n_steps, cfg, **kw)
            stats["profiled_steps"] = stats.get("profiled_steps", 0) \
                + n_steps
            if r + 1 not in profile_rounds:
                slices.stop()
            return out
        t0 = time.perf_counter()
        out = orig(cascade, junctions, fr, n_steps, cfg, **kw)
        sync()
        stats["seconds"] = stats.get("seconds", 0.0) \
            + time.perf_counter() - t0
        stats["steps"] = stats.get("steps", 0) + n_steps
        return out

    setattr(module, name, timed)
    return orig


def merged(slices) -> Slices:
    """One Slices holding every slice of `slices`."""
    m = Slices()
    for s in slices:
        m.device += s.device
        m.host += s.host
        m.windows += s.windows
        m.window_s += s.window_s
    return m
