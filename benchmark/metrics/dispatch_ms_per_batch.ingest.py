"""Milliseconds per stream batch that the host spends issuing work: the
program's spans stream_step/load (the insert) and stream_step/scan_batch
less the blocking reads inside them (`sync`), over the stream steps of
the profiled slice. The scan_batch span opens inside the method, so the
benchmark's synchronizes around it stay outside. Moves
ingest_batch_p95_ms."""
from benchmark.metrics import _spans

HALVES = ("load", "scan_batch")


def _dispatch(ev):
    whole = sum(s for s, names in ev if len(names) == 1
                and names[0] in HALVES)
    waits = sum(s for s, names in ev if len(names) > 1
                and names[0] in HALVES and names[-1] == "sync")
    return 1e3 * (whole - waits)


def read(ctx):
    return _spans.per_step(ctx, _dispatch)
