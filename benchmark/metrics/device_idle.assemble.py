"""Share of the profiled slices (load batches 4-7, scan batches 4-7 and
walk rounds 8-11 of the first assembly) in which no operation ran on the
device: 100 * (1 - union of device intervals / slice time). Feeds
assembly_s.assemble (moves: device_peak_gib)."""
from benchmark import trace


def read(ctx):
    sl = trace.merged((ctx.get("slices") or {}).values())
    if not sl.window_s or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
