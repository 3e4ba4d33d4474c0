"""Milliseconds of the load half of Pipeline.stream_step per batch (the
cascade insert and its kmerisation): from the batch's hand-off to the
start of its scan, closed by a synchronize; mean over the window's
batches outside the profiled slice. Moves ingest_batch_p95_ms."""


def read(ctx):
    v = (ctx.get("batches") or {}).get("load_ms") or []
    return sum(v) / len(v) if v else None
