"""The readers of the program's own spans: the build's parts and the
walk's from each assembly's timers, the stream batch's syncs, probe
rounds and dispatch time from the profiled slices' faucet. host events;
None where the program has no such spans."""
import pytest

from benchmark import run, trace

from benchmark.tests.helpers import tiny

ASSEMBLE = ("build_extract_s.assemble", "build_pass1_host_s.assemble",
            "build_pass2_host_s.assemble", "build_repair_s.assemble",
            "walk_resolve_s.assemble", "walk_collect_s.assemble")
INGEST = ("host_syncs_per_batch.ingest", "sync_wait_ms_per_batch.ingest",
          "upsert_rounds_per_batch.ingest", "dispatch_ms_per_batch.ingest")


def _timers(scale):
    t = {"load": 1.0, "scan": 2.0, "clean": 0.5, "walk": 3.0,
         "build": 10.0,
         "build/extract": 1.0, "build/extract/sync": 0.25,
         "build/pass1": 5.0, "build/pass1/walk": 4.0,
         "build/pass1/walk/round": 3.0, "build/pass1/walk/resolve": 0.5,
         "build/pass1/walk/resolve/sync": 0.1,
         "build/pass1/walk/collect": 0.25,
         "build/pass2": 3.5, "build/pass2/walk": 2.0,
         "build/pass2/walk/resolve": 0.25,
         "build/pass2/walk/collect": 0.5,
         "build/repair": 0.5}
    return {k: v * scale for k, v in t.items()}


def test_build_and_walk_readers_from_timers():
    ctx = {"assemblies": [_timers(1.0), _timers(2.0)]}
    got = {n: run.read_metric(n, ctx) for n in ASSEMBLE}
    # means over the two assemblies (x1.5)
    assert got == pytest.approx({
        "build_extract_s.assemble": 0.75 * 1.5,   # self time: less sync
        "build_pass1_host_s.assemble": 1.0 * 1.5,  # pass less its walk
        "build_pass2_host_s.assemble": 1.5 * 1.5,
        "build_repair_s.assemble": 0.5 * 1.5,
        "walk_resolve_s.assemble": 0.75 * 1.5,     # both passes
        "walk_collect_s.assemble": 0.75 * 1.5})


def test_a_pass_without_walks_reads_its_whole_time():
    t = _timers(1.0)
    del t["build/pass2/walk"]
    ctx = {"assemblies": [t]}
    assert run.read_metric("build_pass2_host_s.assemble", ctx) == 3.5


def _stream_slices():
    ms = 1_000_000
    s = trace.Slices()
    s.windows, s.window_s = [(0, 40 * ms)], 0.04
    host = []
    for b in range(2):  # two batches of 20 ms
        t = 20 * ms * b
        host += [(t, t + 19 * ms, "bench.stream_step"),
                 (t, t + 19 * ms, "faucet.stream_step"),
                 (t, t + 4 * ms, "faucet.stream_step/load"),
                 (t + 4 * ms, t + 18 * ms, "bench.scan_batch"),
                 (t + 5 * ms, t + 17 * ms, "faucet.stream_step/scan_batch"),
                 (t + 6 * ms, t + 7 * ms,
                  "faucet.stream_step/scan_batch/probe_round"),
                 (t + 7 * ms, t + 8 * ms,
                  "faucet.stream_step/scan_batch/probe_round"),
                 (t + 8 * ms, t + 11 * ms,
                  "faucet.stream_step/scan_batch/sync"),
                 (t + 12 * ms, t + 13 * ms,
                  "faucet.stream_step/scan_batch/sync"),
                 (t + 8 * ms, t + 10 * ms, "aten::item")]
    s.host = host + [(38 * ms, 39 * ms, "faucet.flush/sync")]
    return s


def test_stream_batch_readers_from_host_events():
    ctx = {"slices": {"stream": _stream_slices()}}
    got = {n: run.read_metric(n, ctx) for n in INGEST}
    assert got == pytest.approx({
        "host_syncs_per_batch.ingest": 2.0,
        "sync_wait_ms_per_batch.ingest": 4.0,
        "upsert_rounds_per_batch.ingest": 2.0,
        # load 4 ms + scan_batch 12 ms, less 4 ms of syncs
        "dispatch_ms_per_batch.ingest": 12.0})


def test_span_readers_find_nothing_in_a_program_without_spans():
    parent = {"assemblies": [{"load": 1.0, "scan": 2.0, "build": 5.0,
                              "clean": 0.5, "walk": 3.0}]}
    s = _stream_slices()
    s.host = [x for x in s.host if not x[2].startswith("faucet.")]
    for name in ASSEMBLE + INGEST:
        assert run.read_metric(name, {}) is None
        assert run.read_metric(name, parent) is None
        assert run.read_metric(name, {"slices": {"stream": s}}) is None


def test_stream_readers_match_the_program_tally():
    """Stream steps of a tiny cell on the CPU under the profiler: the
    readers count what the program's tally counted."""
    cell = run.DRIVERS["ingest"](tiny("saureus-k55.ingest",
                                      genome_len=6000), 3, "cpu")
    p = cell.pipeline()
    p.stream_step(*cell.batch(0))
    before = dict(p.metrics.tally)
    sl = trace.Slices()
    sl.start()
    for i in range(1, 3):
        p.stream_step(*cell.batch(i))
    sl.stop()
    ctx = {"slices": {"stream": sl}}
    per = lambda k: (p.metrics.tally[k] - before[k]) / 2
    assert run.read_metric("host_syncs_per_batch.ingest", ctx) \
        == per("host_syncs") > 0
    assert run.read_metric("upsert_rounds_per_batch.ingest", ctx) \
        == per("table_probe_rounds") > 0
    assert 0 < run.read_metric("sync_wait_ms_per_batch.ingest", ctx) \
        < run.read_metric("dispatch_ms_per_batch.ingest", ctx)
