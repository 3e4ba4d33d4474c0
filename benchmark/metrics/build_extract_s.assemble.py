"""Seconds of the graph build's extraction per assembly: span
build/extract (the junction and sink tables to the host, the junction
index) less its children (the blocking reads, `sync`), mean over the
window's assemblies but the profiled one. Moves device_peak_gib."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_assembly(
        ctx, lambda t: _spans.self_s(t, "build/extract"))
