"""Host seconds of the graph build's pass 1 (walks from every covered junction slot, then their contigs) per assembly:
span build/pass1 less its walks (span build/pass1/walk: rounds,
resolution, pending tests and the host collection between wave calls),
mean over the window's assemblies but the profiled one. Moves
device_peak_gib."""
from benchmark.metrics import _spans


def _host(t):
    if "build/pass1" not in t:
        return None
    return t["build/pass1"] - t.get("build/pass1/walk", 0.0)


def read(ctx):
    return _spans.per_assembly(ctx, _host)
