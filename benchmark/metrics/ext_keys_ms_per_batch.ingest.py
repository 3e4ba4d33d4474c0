"""Milliseconds per stream batch that the host spends building the ext8
junction test's eight extension keys of every window (the program's
`ext_keys` spans inside its stream_step spans, summed), over the stream
steps of the profiled slice. A program without the span reads None.
Moves ingest_batch_p95_ms."""
from benchmark.metrics import _spans


def read(ctx):
    events, steps = _spans.step_events(ctx)
    secs = [s for s, names in events if names[-1] == "ext_keys"]
    return 1e3 * sum(secs) / steps if secs and steps else None
