"""Milliseconds per stream batch that the host spends in blocking reads
of device values (the program's `sync` spans inside its stream_step
spans, summed), over the stream steps of the profiled slice. Moves
ingest_batch_p95_ms."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_step(
        ctx, lambda ev: 1e3 * sum(s for s, names in ev
                                  if names[-1] == "sync"))
