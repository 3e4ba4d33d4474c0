"""Hash-table probe rounds per stream batch (core/table.py: one span
probe_round per round of an upsert's or lookup's probe loop) inside the
program's stream_step spans, over the stream steps of the profiled
slice. Moves ingest_batch_p95_ms."""
from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_step(
        ctx, lambda ev: sum(1 for _, names in ev
                            if names[-1] == "probe_round"))
