"""Seconds of graph cleaning per assembly (Metrics timer `clean`), over
the window's assemblies but the profiled one. Feeds assembly_s.assemble
(moves: device_peak_gib)."""


def read(ctx):
    a = ctx.get("assemblies") or []
    if not a:
        return None
    return sum(x["clean"] for x in a) / len(a)
