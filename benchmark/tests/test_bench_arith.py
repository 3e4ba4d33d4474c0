"""The metric arithmetic on synthetic inputs: end-to-end metrics, the
idle share of a kernel timeline, the roofline counts and the readers."""
import math

import pytest

from benchmark import roofline, run, trace


def test_assembly_s_is_total_over_count():
    assert run.assembly_s([10.0, 12.0, 14.0, 20.0]) == 14.0


def test_ingest_rate_counts_batches_done_by_the_close():
    # (hand-off, completion, reads): the last completes after the close
    done = [(0.0, 0.1, 100), (0.1, 0.3, 100), (0.3, 0.9, 100),
            (0.9, 1.2, 50)]
    m = run.ingest_metrics(done, t_end=1.0, seconds=1.0)
    assert m["reads_per_s"] == 300.0


def test_ingest_p95_is_over_every_batch():
    done = [(float(i), float(i) + (0.2 if i == 99 else 0.1), 1)
            for i in range(100)]
    m = run.ingest_metrics(done, t_end=1e9, seconds=100.0)
    # numpy's linear percentile: 95% of the way, between the 95th and
    # 96th of 100 sorted latencies, all 100 ms
    assert m["ingest_batch_p95_ms"] == pytest.approx(100.0)
    done[-6:] = [(h, h + 0.3, 1) for h, _, _ in done[-6:]]
    assert run.ingest_metrics(done, 1e9, 100.0)["ingest_batch_p95_ms"] \
        == pytest.approx(300.0)


def _slices():
    s = trace.Slices()
    ms = 1_000_000
    # a 100 ms slice; kernels at 10-30 ms and 20-40 ms overlap, 60-70 ms
    s.windows = [(0, 100 * ms)]
    s.window_s = 0.1
    s.device = [(10 * ms, 30 * ms, "k1"), (20 * ms, 40 * ms, "k2"),
                (60 * ms, 70 * ms, "ft_contains_kernel")]
    s.host = [(0, 100 * ms, "bench.scan_batch"),
              (45 * ms, 55 * ms, "aten::item")]
    return s


def test_idle_share_from_a_kernel_timeline():
    s = _slices()
    assert s.busy_s() == pytest.approx(0.04)
    assert s.launches() == 3
    assert sum(b - a for a, b in s.gaps()) / 1e9 == pytest.approx(0.06)
    ctx = {"slices": {"x": s}}
    assert run.read_metric("device_idle.ingest", ctx) == pytest.approx(60.0)
    bd = s.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(0.02)]
    assert bd["idle_gaps"] == [["scan_batch", pytest.approx(0.03)],
                               ["scan_batch: aten::item",
                                pytest.approx(0.02)],
                               ["scan_batch", pytest.approx(0.01)]]


def test_merged_slices_add_up():
    m = trace.merged([_slices(), _slices()])
    assert m.window_s == pytest.approx(0.2) and m.launches() == 6


def test_roofline_counts():
    # 1,000 lanes, 600 live, a 1-byte mask each, 100 blocks, 3 hashes
    b, o = roofline.probe_counts(1000, 1000, 600, 100, 3)
    assert b == 1000 + 16 * 600 + 1000 + 64 * 100
    assert o == 600 * (40 + 20 * 3)
    b, o = roofline.cascade_counts(1000, 600, 150, 50, 5, 3)
    assert b == 3000 + 16 * 600 + 64 * 200
    assert o == 600 * (40 + 20 * 8)
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    secs, n = roofline.device_seconds(_slices().device, "probe")
    assert n == 1 and secs == pytest.approx(0.01)


def test_timer_readers():
    a = [{"load": 1.0, "scan": 2.0, "build": 5.0, "clean": 0.5,
          "walk": 3.0},
         {"load": 1.5, "scan": 2.5, "build": 6.0, "clean": 0.7,
          "walk": 4.0}]
    ctx = {"assemblies": a, "walk": {"seconds": 7.0, "steps": 7000,
                                     "profiled_steps": 1024}}
    assert run.read_metric("load_scan_s.assemble", ctx) == 3.5
    assert run.read_metric("build_host_s.assemble", ctx) == 2.0
    assert run.read_metric("clean_s.assemble", ctx) == pytest.approx(0.6)
    assert run.read_metric("walk_ms_per_step.assemble", ctx) == 1.0
    assert run.read_metric("load_ms_per_batch.ingest",
                           {"batches": {"load_ms": [1.0, 3.0]}}) == 2.0


def test_window_readers():
    ctx = {"window": {"assembly_s": 21.5, "reads_per_s": 2.9e5,
                      "device_peak_gib": 0.5}}
    assert run.read_metric("assembly_s.assemble", ctx) == 21.5
    assert run.read_metric("reads_per_s.ingest", ctx) == 2.9e5


def test_readers_find_nothing_to_read():
    for name in ("assembly_s.assemble", "reads_per_s.ingest",
                 "load_scan_s.assemble", "walk_ms_per_step.assemble",
                 "walk_launches_per_step.assemble", "device_idle.assemble",
                 "probe_roofline.ingest", "cascade_roofline.ingest",
                 "scan_ms_per_batch.ingest"):
        assert run.read_metric(name, {}) is None
    assert not math.isnan(run.read_metric("clean_s.assemble", {
        "assemblies": [{"clean": 1.0}]}))
