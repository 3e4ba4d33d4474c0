"""Seconds of the load and scan passes per assembly (Metrics timers
`load` + `scan`, each phase closed by a synchronize), over the window's
assemblies but the profiled one. Feeds assembly_s.assemble (moves:
device_peak_gib)."""


def read(ctx):
    a = ctx.get("assemblies") or []
    if not a:
        return None
    return sum(x["load"] + x["scan"] for x in a) / len(a)
