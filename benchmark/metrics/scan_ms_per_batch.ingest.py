"""Milliseconds of Pipeline.scan_batch inside stream_step per batch (the
8-way extension probe, runs, junction and sink upserts), host clock
between two synchronizes; mean over the window's batches outside the
profiled slice. Moves ingest_batch_p95_ms."""


def read(ctx):
    v = (ctx.get("batches") or {}).get("scan_ms") or []
    return sum(v) / len(v) if v else None
