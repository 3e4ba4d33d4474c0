"""The reader of the program's upsert spans (core/table.py upsert, the
hash tables' inserts): milliseconds a stream batch from the profiled
slices' faucet. host events, less the blocking reads inside them; None
where the program has no such span."""
import pytest

from benchmark import run, trace
from benchmark.metrics import _spans

from benchmark.tests.helpers import tiny

NAME = "upsert_ms_per_batch.ingest"


def _slices(with_span: bool):
    ms = 1_000_000
    s = trace.Slices()
    s.windows, s.window_s = [(0, 40 * ms)], 0.04
    for b in range(2):  # two batches of 20 ms
        t = 20 * ms * b
        s.host += [(t, t + 19 * ms, "faucet.stream_step"),
                   (t + 5 * ms, t + 17 * ms,
                    "faucet.stream_step/scan_batch")]
        if with_span:
            up = "faucet.stream_step/scan_batch/upsert"
            s.host += [(t + 6 * ms, t + 7 * ms, up),
                       # a blocking read inside the second upsert
                       (t + 8 * ms, t + 10 * ms, up),
                       (t + 9 * ms, t + 9 * ms + ms // 2, up + "/sync")]
    s.host.append((38 * ms, 39 * ms, "faucet.flush/spool_flush/upsert"))
    return s


def test_upsert_reader_from_host_events():
    ctx = {"slices": {"stream": _slices(True)}}
    # (1 + 2 - 0.5) ms a step; the upsert outside a step is left out
    assert run.read_metric(NAME, ctx) == pytest.approx(2.5)


def test_upsert_reader_finds_nothing_without_the_span():
    assert run.read_metric(NAME, {}) is None
    assert run.read_metric(NAME, {"slices": {"stream": _slices(False)}}) \
        is None


@pytest.mark.parametrize("cell", ["saureus-k55.ingest",
                                  "ecoli-k31-whole.ingest"])
def test_upsert_reader_on_a_tiny_stream(cell):
    """Stream steps of a tiny ingest cell on the CPU under the profiler:
    upsert spans inside the steps' issuing, their probe rounds inside
    them (the torch rounds of the CPU)."""
    drv = run.DRIVERS["ingest"](tiny(cell, genome_len=6000), 3, "cpu")
    p = drv.pipeline()
    p.stream_step(*drv.batch(0))
    sl = trace.Slices()
    sl.start()
    for i in range(1, 3):
        p.stream_step(*drv.batch(i))
    sl.stop()
    ctx = {"slices": {"stream": sl}}
    events, steps = _spans.step_events(ctx)
    assert steps == 2
    ups = [names for _, names in events if names[-1] == "upsert"]
    assert len(ups) >= 2
    rounds = [names for _, names in events if names[-1] == "probe_round"]
    assert rounds and all("upsert" in names for names in rounds)
    assert 0 < run.read_metric(NAME, ctx) \
        < run.read_metric("dispatch_ms_per_batch.ingest", ctx)
