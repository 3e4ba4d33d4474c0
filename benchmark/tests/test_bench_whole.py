"""The cell ecoli-k31-whole.ingest at a tiny size on the CPU: the port's
stream against the plain reference and the control, a whole run_cell,
and the readers of the branch-node cascade's and the junction spool's
spans (node_ms_per_batch, spool_ms_per_batch) and of the D -> E inserts'
roofline (node_cascade_roofline): each matches the program's tally or the
recorded calls, and reads None on a program without the spans and on the
k = 55 cell."""
import json
import os

import pytest

from benchmark import check, roofline, run, sizing, trace
from benchmark.metrics import _spans

from benchmark.tests.helpers import tiny
from benchmark.tests.test_bench_reference import _program, _reference

CELL = "ecoli-k31-whole.ingest"
NODE, SPOOL, ROOF = ("node_ms_per_batch.ingest", "spool_ms_per_batch.ingest",
                     "node_cascade_roofline.ingest")


def test_the_configuration_is_the_published_one_uncut():
    spec = run.load_spec(CELL)
    cfg = spec["config"]
    assert spec["workload"]["passes"] == "ingest"
    assert spec["workload"]["chips"] == 1
    assert cfg["genome_len"] == 4_641_652 and cfg["reduced"] == {}
    assert "published_genome_len" not in cfg
    with open(os.path.join(run.HERE, "configs", "ecoli-k31.json")) as f:
        cut = json.load(f)
    same = set(cut) - {"name", "source", "genome_len",
                       "published_genome_len", "reduced", "assumed"}
    assert {k: cfg[k] for k in same} == {k: cut[k] for k in same}
    n = int(cfg["coverage"] * cfg["genome_len"] / cfg["read_len"])
    kw = sizing.program_kwargs(cfg, n)
    assert (n, -(-n // cfg["batch_reads"])) == (2_320_826, 284)
    assert sizing.filters(kw) == {"a": (29, 7), "b": (26, 4),
                                  "d": (28, 3), "e": (26, 3)}


def test_the_stream_equals_the_reference_and_the_control_does_not():
    prog, kw, batches, p = _program(tiny(CELL), 2 ** 40 + 5, True)
    assert kw["size_kmer"] == 31 and p.node_cascade is not None
    assert int(p.junctions.count) > 0
    good = _reference(kw, batches, True)
    assert check.state_numbers(prog, good) == {
        "filter_words_differ": 0, "junction_rows_differ": 0,
        "sink_rows_differ": 0}
    ctl = _reference(kw, batches, True, hash_delta=-1)
    as_prog = {"filters": ctl.filter_words(),
               "junctions": ctl.tables()["junctions"],
               "sinks": ctl.tables()["sinks"]}
    nums = check.state_numbers(as_prog, good)
    assert nums["filter_words_differ"] > 0 and not check.verdict(nums)


def test_run_cell_of_the_tiny_cell_is_correct():
    res = run.run_cell(tiny(CELL), 2 ** 33 + 7, 0.2, False, device="cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["reads_per_s"] > 0
    assert set(res["numbers"]) == {"filter_words_differ",
                                   "junction_rows_differ",
                                   "sink_rows_differ"}


def _profiled_steps(cell, n=2):
    """Stream steps 1..n of a tiny cell on the CPU under the profiler and
    the recorder: (ctx as a traced run leaves it, Pipeline, tally before
    the slice)."""
    c = run.DRIVERS["ingest"](tiny(cell, genome_len=6000), 3, "cpu")
    p = c.pipeline()
    p.stream_step(*c.batch(0))
    before = dict(p.metrics.tally)
    sl, rec = trace.Slices(), roofline.Recorder()
    try:
        sl.start()
        rec.on = True
        for i in range(1, n + 1):
            p.stream_step(*c.batch(i))
        sl.stop()
    finally:
        rec.on = False
        rec.close()
    return {"cell": cell, "slices": {"stream": sl}, "recorder": rec}, p, \
        before


def test_node_and_spool_readers_on_a_tiny_stream():
    ctx, p, before = _profiled_steps(CELL)
    events, steps = _spans.step_events(ctx)
    leaves = [names[-1] for _, names in events]
    assert steps == 2
    assert leaves.count("node_insert") == leaves.count("node_probe") == 2
    assert leaves.count("spool_append") == 2
    grew = p.metrics.tally["node_keys"] - before["node_keys"]
    B, P = 512, p.cfg.positions_per_read
    assert grew == 2 * 2 * B * P
    dispatch = run.read_metric("dispatch_ms_per_batch.ingest", ctx)
    node, spool = run.read_metric(NODE, ctx), run.read_metric(SPOOL, ctx)
    assert 0 < node < dispatch and 0 < spool < dispatch
    # the spool's one blocking read a batch (its compaction count) is left
    # out: the reader is the span's time less its sync
    whole = sum(s for s, n in events if n[-1] == "spool_append") / steps
    wait = sum(s for s, n in events
               if n[-1] == "sync" and "spool_append" in n) / steps
    assert wait > 0 and spool == pytest.approx(1e3 * (whole - wait))


def _slices(leaves):
    ms = 1_000_000
    s = trace.Slices()
    s.windows, s.window_s = [(0, 40 * ms)], 0.04
    for b in range(2):  # two batches of 20 ms
        t = 20 * ms * b
        s.host += [(t, t + 19 * ms, "faucet.stream_step"),
                   (t, t + 4 * ms, "faucet.stream_step/load")]
        if "node_insert" in leaves:
            s.host.append((t + 1 * ms, t + 3 * ms,
                           "faucet.stream_step/load/node_insert"))
        s.host.append((t + 5 * ms, t + 17 * ms,
                       "faucet.stream_step/scan_batch"))
        if "node_probe" in leaves:
            s.host.append((t + 6 * ms, t + 7 * ms,
                           "faucet.stream_step/scan_batch/node_probe"))
        if "spool_append" in leaves:
            a = "faucet.stream_step/scan_batch/spool_append"
            s.host += [(t + 8 * ms, t + 12 * ms, a),
                       (t + 9 * ms, t + 10 * ms, a + "/sync")]
            if b == 1:  # a flush forced in the second batch
                s.host += [(t + 10 * ms, t + 12 * ms, a + "/spool_flush"),
                           (t + 11 * ms, t + 12 * ms,
                            a + "/spool_flush/sync")]
    # a phase-end flush outside the stream steps is left out
    s.host.append((38 * ms, 39 * ms, "faucet.flush/spool_flush"))
    return s


def test_node_and_spool_readers_from_host_events():
    ctx = {"slices": {"stream": _slices(("node_insert", "node_probe",
                                         "spool_append"))}}
    # node: 2 + 1 ms a step; spool: 4 ms less 1 ms (and 1 ms more in the
    # flushing step's flush): (3 + 2) / 2
    assert run.read_metric(NODE, ctx) == pytest.approx(3.0)
    assert run.read_metric(SPOOL, ctx) == pytest.approx(2.5)


def test_readers_find_nothing_without_the_spans_or_on_the_wide_cell():
    for name in (NODE, SPOOL, ROOF):
        assert run.read_metric(name, {}) is None
        assert run.read_metric(name, {"slices": {"stream": _slices(())}}) \
            is None
    ctx, _, _ = _profiled_steps("saureus-k55.ingest")
    assert _spans.step_events(ctx)[1] == 2
    for name in (NODE, SPOOL, ROOF):
        assert run.read_metric(name, ctx) is None


def _device_events(rec, us=(10, 20, 5)):
    """Cascade launches for the recorded calls, three a call in launch
    order (count, apply, clear), of us microseconds each, 1 us apart."""
    out, t = [], 0
    for _ in rec.calls["cascade"]:
        for name, d in zip(roofline.KERNELS["cascade"], us):
            out.append((t, t + 1000 * d, f"void {name}<4>(int*)"))
            t += 1000 * (d + 1)
    return out


def test_node_cascade_roofline_over_the_recorded_d_to_e_calls(monkeypatch):
    ctx, p, _ = _profiled_steps(CELL)
    # the tiny configuration is what load_spec gives the cell
    spec = tiny(CELL, genome_len=6000)
    monkeypatch.setattr(run, "load_spec", lambda cell, root=run.HERE: spec)
    la = p.cfg.node_view().bloom_a_bits.bit_length() - 1
    lb = p.cfg.node_view().bloom_b_bits.bit_length() - 1
    rec = ctx["recorder"]
    calls = rec.calls["cascade"]
    node = [c for c in calls if tuple(c[0][5:7]) == (la, lb)]
    # each step inserts A -> B, then D -> E
    assert len(calls) == 4 and [calls[1], calls[3]] == node
    assert (la, lb) != tuple(calls[0][0][5:7])
    ctx["slices"]["stream"].device = _device_events(rec)
    least = 0.0
    for c in node:
        only = roofline.Recorder.__new__(roofline.Recorder)
        only.calls = {"probe": [], "cascade": [c]}
        least += only.bounds()["cascade"][0]
    # two D -> E calls of 35 us of launches each
    assert run.read_metric(ROOF, ctx) == pytest.approx(
        100 * least / 70e-6)
    assert 0 < run.read_metric(ROOF, ctx) < 100
    # launches that do not come three a call, in order, read nothing
    dev = ctx["slices"]["stream"].device
    ctx["slices"]["stream"].device = dev[:-1]
    assert run.read_metric(ROOF, ctx) is None
    swap = [dev[0][:2] + dev[1][2:], dev[1][:2] + dev[0][2:]]
    ctx["slices"]["stream"].device = swap + dev[2:]
    assert run.read_metric(ROOF, ctx) is None
