"""Reads ingested per second, as run.ingest_metrics takes them: the
reads of every batch completed on the device by the close, over the
traced run's window. The traced run closes each batch's scan half with a
synchronize and profiles 16 batches, so this reads below an untraced
run. Moves ingest_batch_p95_ms."""


def read(ctx):
    return (ctx.get("window") or {}).get("reads_per_s")
