"""Milliseconds per stream batch that the host spends in the program's
hash-table upserts: the spans upsert (core/table.py upsert: the batch's
sort and combine, then its probe rounds, one kernel launch on the card)
inside the stream steps, less the blocking reads inside them, over the
stream steps of the profiled slice. A program without the span reads
None. Moves ingest_batch_p95_ms."""
from benchmark.metrics import _issuing


def read(ctx):
    return _issuing.ms_per_step(ctx, ("upsert",))
