"""Host seconds of the graph build's pass 2 (the visited k-mers of pass 1, walks from sink anchors in chunks, their contigs) per assembly:
span build/pass2 less its walks (span build/pass2/walk: rounds,
resolution, pending tests and the host collection between wave calls),
mean over the window's assemblies but the profiled one. Moves
device_peak_gib."""
from benchmark.metrics import _spans


def _host(t):
    if "build/pass2" not in t:
        return None
    return t["build/pass2"] - t.get("build/pass2/walk", 0.0)


def read(ctx):
    return _spans.per_assembly(ctx, _host)
