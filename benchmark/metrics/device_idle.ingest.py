"""Share of the profiled slice (window batches 20-35 of the stream) in
which no operation ran on the device: 100 * (1 - union of device
intervals / slice time). Moves ingest_batch_p95_ms."""
from benchmark import trace


def read(ctx):
    sl = trace.merged((ctx.get("slices") or {}).values())
    if not sl.window_s or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
