"""Blocking reads of device values per stream batch: the program's
`sync` spans (one per Metrics.fetch) inside its stream_step spans, over
the stream steps of the profiled slice (window batches 20-35). Moves
ingest_batch_p95_ms."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_step(
        ctx, lambda ev: sum(1 for _, names in ev if names[-1] == "sync"))
