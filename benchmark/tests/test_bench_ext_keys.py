"""The reader of the program's ext_keys spans (the ext8 junction test's
eight extension keys of a wide scan): milliseconds a stream batch from
the profiled slices' faucet. host events; None where the program has no
such span."""
import pytest

from benchmark import run, trace
from benchmark.metrics import _spans

from benchmark.tests.helpers import tiny

NAME = "ext_keys_ms_per_batch.ingest"


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
            s.host.append((t + 6 * ms, t + 6 * ms + (b + 1) * ms // 4,
                           "faucet.stream_step/scan_batch/ext_keys"))
    s.host.append((38 * ms, 39 * ms, "faucet.scan/scan_batch/ext_keys"))
    return s


def test_ext_keys_reader_from_host_events():
    ctx = {"slices": {"stream": _slices(True)}}
    # 0.25 + 0.5 ms over two steps; the span outside a step is left out
    assert run.read_metric(NAME, ctx) == pytest.approx(0.375)


def test_ext_keys_reader_finds_nothing_without_the_span():
    assert run.read_metric(NAME, {}) is None
    assert run.read_metric(NAME, {"slices": {"stream": _slices(False)}}) \
        is None


def test_ext_keys_reader_on_a_tiny_wide_stream():
    """Stream steps of a tiny k = 55 cell on the CPU under the profiler:
    one ext_keys span a step, inside the step's issuing."""
    cell = run.DRIVERS["ingest"](tiny("saureus-k55.ingest",
                                      genome_len=6000), 3, "cpu")
    p = cell.pipeline()
    p.stream_step(*cell.batch(0))
    sl = trace.Slices()
    sl.start()
    for i in range(1, 3):
        p.stream_step(*cell.batch(i))
    sl.stop()
    ctx = {"slices": {"stream": sl}}
    events, steps = _spans.step_events(ctx)
    assert steps == 2
    assert sum(names[-1] == "ext_keys" for _, names in events) == 2
    assert 0 < run.read_metric(NAME, ctx) \
        < run.read_metric("dispatch_ms_per_batch.ingest", ctx)
