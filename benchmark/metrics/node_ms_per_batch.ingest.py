"""Milliseconds per stream batch that the host spends on the branch-node
cascade: the program's spans node_insert (in the load half: the endpoint
keys and the sparse D -> E insert) and node_probe (in the scan half: the
branch keys and the two E-probes) less the blocking reads inside them,
over the stream steps of the profiled slice. A program without the spans,
or a stream without the node cascade (k > 31), reads None. Moves
ingest_batch_p95_ms."""
from benchmark.metrics import _issuing


def read(ctx):
    return _issuing.ms_per_step(ctx, ("node_insert", "node_probe"))
