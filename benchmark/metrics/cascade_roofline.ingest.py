"""Share of the roofline reached by cascade_insert (kernels/cascade.py,
csrc/cascade.cu: three launches a call, count, apply and clear) over the
profiled slice of the stream: the least time its calls need
(benchmark/roofline.py, from each call's inputs) over the summed device
time of every launch that implements them. Nothing is read when the
launches do not match the calls. Moves ingest_batch_p95_ms."""
from benchmark import roofline, trace

LAUNCHES_PER_CALL = 3


def read(ctx):
    rec = ctx.get("recorder")
    if rec is None:
        return None
    sl = trace.merged((ctx.get("slices") or {}).values())
    secs, launches = roofline.device_seconds(sl.device, "cascade")
    least, calls = rec.bounds()["cascade"]
    if not calls or not secs or launches != LAUNCHES_PER_CALL * calls:
        return None
    return 100.0 * least / secs
