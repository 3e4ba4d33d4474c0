"""Host seconds of the graph build per assembly: Metrics timer `build`
less the walk rounds' own seconds (the benchmark's round timer), over
the window's assemblies but the profiled one. Feeds assembly_s.assemble
(moves: device_peak_gib)."""


def read(ctx):
    a = ctx.get("assemblies") or []
    if not a:
        return None
    return sum(x["build"] - x["walk"] for x in a) / len(a)
