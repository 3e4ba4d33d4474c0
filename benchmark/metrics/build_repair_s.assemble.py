"""Seconds of the graph build's port repair per assembly (span
build/repair: the ContigGraph, resolve_port_clashes and repair_ports),
mean over the window's assemblies but the profiled one. Moves
device_peak_gib."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_assembly(ctx, lambda t: t.get("build/repair"))
