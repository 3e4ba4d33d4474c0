"""Share of the roofline reached by the branch-node cascade's sparse
D -> E inserts alone (core/scan.py load_batch_nodes_s through
kernels/cascade.py cascade_insert; csrc/cascade.cu, three launches a
call: count, apply, clear) over the profiled slice of the stream.

The D -> E calls are the recorded cascade calls whose filters are D's
and E's sizes (log2 bits la, lb; benchmark/sizing.py filters, from the
cell's configuration). Each recorded call is paired with the three
cascade launches it made, in launch order on the one stream. The share
is the least time of the D -> E calls (benchmark/roofline.py, from each
call's inputs) over the device time of their launches. Nothing is read
when the launches do not come three a call in that order, or when no
D -> E call was recorded (k > 31). Moves ingest_batch_p95_ms."""
import copy

from benchmark import roofline, run, sizing, trace

KERNELS = roofline.KERNELS["cascade"]  # count, apply, clear: launch order


def node_bits(cell: str):
    """(la, lb) of the cell's D -> E inserts, or None without the node
    cascade. D and E are sized from the genome's k-mers alone, so the
    read count (which sizes only A) is left at 0."""
    cfg = run.load_spec(cell)["config"]
    f = sizing.filters(sizing.program_kwargs(cfg, 0))
    return (f["d"][0], f["e"][0]) if "d" in f else None


def read(ctx):
    rec = ctx.get("recorder")
    if rec is None or "cell" not in ctx:
        return None
    bits = node_bits(ctx["cell"])
    calls = rec.calls["cascade"]
    sl = trace.merged((ctx.get("slices") or {}).values())
    launches = sorted(e for e in sl.device
                      if any(k in e[2] for k in KERNELS))
    if bits is None or not calls \
            or len(launches) != len(KERNELS) * len(calls):
        return None
    mine, secs = [], 0.0
    for i, call in enumerate(calls):
        trio = launches[len(KERNELS) * i:len(KERNELS) * (i + 1)]
        if not all(k in n for k, (_, _, n) in zip(KERNELS, trio)):
            return None
        if tuple(call[0][5:7]) == bits:
            mine.append(call)
            secs += sum(e - s for s, e, _ in trio) / 1e9
    if not mine or not secs:
        return None
    # the recorder's own count, over the D -> E calls alone
    sub = copy.copy(rec)
    sub.calls, sub._bounds = {"probe": [], "cascade": mine}, None
    return 100.0 * sub.bounds()["cascade"][0] / secs
