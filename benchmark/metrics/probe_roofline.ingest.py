"""Share of the roofline reached by bloom_contains_codes
(kernels/probe.py, csrc/probe.cu: one launch a call) over the profiled
slice of the stream: the least time its calls need
(benchmark/roofline.py, from each call's inputs) over the summed device
time of every launch that implements them. Nothing is read when the
launches do not match the calls. Moves ingest_batch_p95_ms."""
from benchmark import roofline, trace

LAUNCHES_PER_CALL = 1


def read(ctx):
    rec = ctx.get("recorder")
    if rec is None:
        return None
    sl = trace.merged((ctx.get("slices") or {}).values())
    secs, launches = roofline.device_seconds(sl.device, "probe")
    least, calls = rec.bounds()["probe"]
    if not calls or not secs or launches != LAUNCHES_PER_CALL * calls:
        return None
    return 100.0 * least / secs
