"""Seconds of the walk loop's host work per assembly (graph/build.py
_run_walks between wave calls: seeds to the device, strips and frontier
fetched, frontier compaction, capture): every span walk/collect of both
build passes, mean over the window's assemblies but the profiled one.
Moves device_peak_gib."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_assembly(
        ctx, lambda t: _spans.ending(t, "walk/collect"))
