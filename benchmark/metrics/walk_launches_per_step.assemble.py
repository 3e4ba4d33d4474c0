"""Device operations (kernels, copies, sets) per walk step, counted by
torch.profiler over the profiled walk rounds (8-11 of the window, with
the host work between them). Feeds assembly_s.assemble (moves:
device_peak_gib)."""


def read(ctx):
    sl = (ctx.get("slices") or {}).get("walk")
    steps = (ctx.get("walk") or {}).get("profiled_steps")
    if sl is None or not steps or not sl.launches():
        return None
    return sl.launches() / steps
