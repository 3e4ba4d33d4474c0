"""Seconds of resolve_ambiguous per assembly (graph/walk.py, the beam
lookahead after every walk round, with its blocking read): every span
walk/resolve of both build passes, mean over the window's assemblies but
the profiled one. Moves device_peak_gib."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_assembly(
        ctx, lambda t: _spans.ending(t, "walk/resolve"))
