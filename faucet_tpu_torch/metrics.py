# Copied verbatim from faucet_tpu/metrics.py: the port imports nothing of
# faucet_tpu.
"""Structured metrics/logging (SURVEY.md §5 "Metrics / logging": the
reference prints phase counters and wall-clock to stderr; here the same
counters flow to stderr and optionally to a JSONL file, feeding the
BASELINE reads/s / probes/s measurement directly)."""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional


class Metrics:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.path = jsonl_path
        self.counters: Dict[str, float] = {}
        self.timers: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def add(self, key: str, val: float = 1):
        self.counters[key] = self.counters.get(key, 0) + val

    def start(self, phase: str):
        self._t0[phase] = time.perf_counter()

    def stop(self, phase: str):
        dt = time.perf_counter() - self._t0.pop(phase)
        self.timers[phase] = self.timers.get(phase, 0.0) + dt
        return dt

    def emit(self, event: str, **extra):
        rec = {"event": event, "ts": time.time(),
               "counters": dict(self.counters),
               "timers_s": {k: round(v, 4) for k, v in self.timers.items()},
               **extra}
        print(f"[faucet_tpu] {event}: " + ", ".join(
            f"{k}={v}" for k, v in sorted(self.counters.items())),
            file=sys.stderr)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
