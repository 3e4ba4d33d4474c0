"""Milliseconds per lockstep walk step: the walk rounds' seconds, each
round closed by a synchronize, over their steps (the profiled rounds
left out). Feeds assembly_s.assemble (moves: device_peak_gib)."""


def read(ctx):
    w = ctx.get("walk") or {}
    if not w.get("steps"):
        return None
    return 1e3 * w["seconds"] / w["steps"]
