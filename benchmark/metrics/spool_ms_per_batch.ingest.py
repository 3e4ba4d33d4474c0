"""Milliseconds per stream batch that the host spends appending the
batch's junction lanes to the spool: the program's spans spool_append
(in the scan half; a flush forced by a full spool is inside it) less the
blocking reads inside them, over the stream steps of the profiled slice.
A program without the span, or a stream without the spool (wide codes,
k > 31), reads None. Moves ingest_batch_p95_ms."""
from benchmark.metrics import _issuing


def read(ctx):
    return _issuing.ms_per_step(ctx, ("spool_append",))
