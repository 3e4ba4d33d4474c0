"""faucet_tpu_torch's spans and host-sync counters (metrics.py).

Spans nest per thread and time their paths; they enter torch.profiler's
record_function only while the profiler records; every blocking read of a
device value goes through Metrics.fetch, one `sync` span and one
`host_syncs` each; `add` sums device tensors without reading them. The
phase timers keep their names and the build's spans account for it. The
narrow stream spans its branch-node cascade and its junction spool; the
wide one spans neither.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from faucet_tpu_torch import cli as tcli
from faucet_tpu_torch import metrics as M
from faucet_tpu_torch import simulate
from faucet_tpu_torch.config import Config
from faucet_tpu_torch.core import scan as SC
from faucet_tpu_torch.pipeline import Pipeline, batch_iter

# the suite runs in several worker processes on few cores: one torch
# thread each (tiny CPU tensors gain nothing from more)
torch.set_num_threads(1)


def _cfg(k=21, **kw):
    base = dict(size_kmer=k, max_read_length=100, batch_reads=64,
                estimated_kmers=1 << 14, singletons=1 << 14,
                junction_capacity=1 << 13, sink_capacity=1 << 13,
                fp_rate=0.002)
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def reads():
    """tests/test_torch_pipeline.py's repeat case (0.5% errors)."""
    rng = np.random.default_rng(777)
    genome = simulate.genome_with_repeats(rng, 3000, n_repeats=2,
                                          repeat_len=200)
    return simulate.shred(rng, genome, coverage=40, read_len=100,
                          err_rate=0.005, circular=True)


def _batches(reads, cfg):
    return list(batch_iter(reads, cfg))


# ---- the span primitive ----------------------------------------------------


def test_spans_nest_into_paths_and_time_themselves():
    m = M.Metrics()
    with m.span("build"):
        with m.span("pass1"):
            time.sleep(0.02)
            assert M.current() is m
        time.sleep(0.01)
    with m.span("build"):
        pass
    assert set(m.timers) == {"build", "build/pass1"}
    t = m.timers
    assert t["build/pass1"] >= 0.02
    # self time: the parent less its child is the 10 ms outside it
    assert t["build"] - t["build/pass1"] >= 0.01
    assert M.current() is M._default


def test_module_helpers_reach_the_innermost_span_and_stacks_are_per_thread():
    a, b = M.Metrics(), M.Metrics()
    seen = {}

    def other():
        # a thread of its own: empty stack, the process default
        seen["current"] = M.current()
        with b.span("feed"):
            M.count("n")
            seen["path"] = M._stack()[-1].path

    with a.span("load"):
        with M.span("load_batch"):
            M.count("n", 2)
            th = threading.Thread(target=other)
            th.start()
            th.join()
    assert seen == {"current": M._default, "path": "feed"}
    assert set(a.timers) == {"load", "load/load_batch"}
    assert a.tally == {"n": 2} and b.tally == {"n": 1}
    assert set(b.timers) == {"feed"}


def test_fetch_is_a_counted_sync_span_and_add_reads_nothing():
    m = M.Metrics()
    with m.span("scan_batch"):
        m.add("solid_windows", torch.tensor(5))
        m.add("solid_windows", torch.tensor(7))
        m.add("reads", 3)
        assert "host_syncs" not in m.tally
        assert int(m.fetch(torch.tensor(4))) == 4
    assert m.tally == {"host_syncs": 1}
    assert set(m.timers) == {"scan_batch", "scan_batch/sync"}
    # the device sums are read once, on the first read of `counters`
    assert m.counters == {"reads": 3, "solid_windows": 12}
    assert m.tally == {"host_syncs": 2}
    assert m.counters == {"reads": 3, "solid_windows": 12}
    assert m.tally == {"host_syncs": 2}
    rec = m.emit("done")
    assert rec["counters"] == {"reads": 3, "solid_windows": 12}
    assert rec["tally"] == {"host_syncs": 2}


def test_device_tally_counts_join_the_tally_when_counters_are_read():
    """Metrics.on_device hands a kernel one slot of a shared device buffer
    a key; the counts reach the tally (not the reference's counters) in
    the one fetch that reads the counters, and start again from 0."""
    m = M.Metrics()
    m.add("solid_windows", torch.tensor(5))
    lanes = m.on_device("upsert_lanes", "cpu")
    lanes.add_(7)
    m.on_device("upsert_chunks", "cpu").add_(1)
    m.on_device("upsert_lanes", "cpu").add_(2)
    assert m.on_device("upsert_lanes", "cpu").data_ptr() == lanes.data_ptr()
    assert "upsert_lanes" not in m.tally
    assert m.counters == {"solid_windows": 5}
    assert m.tally == {"host_syncs": 1, "upsert_lanes": 9,
                       "upsert_chunks": 1}
    m.on_device("upsert_lanes", "cpu").add_(4)
    assert m.emit("done")["tally"] == {"host_syncs": 2, "upsert_lanes": 13,
                                       "upsert_chunks": 1}
    for i in range(M.TALLY_SLOTS):
        m.on_device(f"k{i}", "cpu")
    with pytest.raises(ValueError):
        m.on_device("one more", "cpu")
    assert m.counters == {"solid_windows": 5} and m.tally["k0"] == 0


# ---- the program's spans ----------------------------------------------------


def _no_record_function(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("record_function entered with the profiler "
                             "off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)


def test_no_record_function_while_the_profiler_is_off(reads, monkeypatch):
    _no_record_function(monkeypatch)
    cfg = _cfg()
    p = Pipeline(cfg, device="cpu")
    for bases, lens in _batches(reads, cfg)[:2]:
        p.stream_step(bases, lens)
    p = Pipeline(cfg, device="cpu")
    p.run_file_mode(reads, reads)
    assert p.metrics.timers["build/pass1/walk/round"] > 0


def _events(prof):
    """(start_ns, end_ns, name) of the profile's faucet. host events."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("faucet.")]


@pytest.mark.parametrize("k", [21, 55])
def test_a_profiled_stream_step_holds_its_syncs(reads, k):
    """One stream step under torch.profiler (CPU): one faucet.stream_step
    event, which encloses every faucet. sync event of the step; as many
    as host_syncs grew, and as many probe_round events as
    table_probe_rounds grew."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(k)
    p = Pipeline(cfg, device="cpu")
    batches = _batches(reads, cfg)
    p.stream_step(*batches[0])
    tally = dict(p.metrics.tally)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p.stream_step(*batches[1])
    ev = _events(prof)
    steps = [e for e in ev if e[2] == "faucet.stream_step"]
    assert len(steps) == 1
    s0, s1, _ = steps[0]
    syncs = [e for e in ev if e[2].endswith("/sync")]
    grew = lambda key: p.metrics.tally[key] - tally.get(key, 0)
    assert syncs and len(syncs) == grew("host_syncs")
    assert all(s0 <= a and b <= s1 for a, b, _ in syncs)
    assert all(n.startswith("faucet.stream_step/") for _, _, n in syncs)
    rounds = [e for e in ev if e[2].endswith("/probe_round")]
    assert rounds and len(rounds) == grew("table_probe_rounds")
    names = {n for _, _, n in ev}
    assert {"faucet.stream_step/load", "faucet.stream_step/scan_batch"} \
        <= names


@pytest.mark.parametrize("k", [21, 55])
def test_the_wide_scan_spans_its_extension_keys(reads, k):
    """A k = 55 stream step builds the ext8 test's extension keys in the
    span stream_step/scan_batch/ext_keys; a k = 21 step (narrow
    codes, the node cascade) has no such span. On the CPU the keys take
    the plain version, so no kernel launch is tallied."""
    cfg = _cfg(k)
    p = Pipeline(cfg, device="cpu")
    for bases, lens in _batches(reads, cfg)[:2]:
        p.stream_step(bases, lens)
    spans = [x for x in p.metrics.timers if x.endswith("ext_keys")]
    assert spans == (["stream_step/scan_batch/ext_keys"] if k > 31 else [])
    assert "wide_ext_launches" not in p.metrics.tally


# the spans of the branch-node cascade and the junction spool (narrow
# codes only)
NODE_SPOOL = ("node_insert", "node_probe", "spool_append", "spool_flush")


@pytest.mark.parametrize("k", [31, 55])
def test_the_narrow_stream_spans_its_node_cascade_and_spool(reads, k):
    """A profiled k = 31 stream step holds node_insert in its load half
    and node_probe and spool_append in its scan half, and tallies
    node_keys: both endpoint keys of every window, the lanes handed to the
    sparse D -> E insert. A k = 55 step (wide codes: ext8, no spool)
    holds none of the four spans and neither tally."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg(k)
    p = Pipeline(cfg, device="cpu")
    batches = _batches(reads, cfg)
    p.stream_step(*batches[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p.stream_step(*batches[1])
    ev = _events(prof)
    steps = [e for e in ev if e[2] == "faucet.stream_step"]
    mine = [e for e in ev if e[2].split("/")[-1] in NODE_SPOOL]
    spans = {x for x in p.metrics.timers if x.split("/")[-1] in NODE_SPOOL}
    tally = p.metrics.tally
    if k > 31:
        assert not mine and not spans
        assert not {"node_keys", "spool_flushes"} & set(tally)
        return
    want = {"stream_step/load/node_insert",
            "stream_step/scan_batch/node_probe",
            "stream_step/scan_batch/spool_append"}
    assert {n[len("faucet."):] for _, _, n in mine} == spans == want
    assert len(mine) == 3 and len(steps) == 1
    s0, s1, _ = steps[0]
    assert all(s0 <= a and b <= s1 for a, b, _ in mine)
    windows = cfg.batch_reads * cfg.positions_per_read
    assert tally["node_keys"] == 2 * 2 * windows
    assert "spool_flushes" not in tally


def _block_reads():
    """Reads of a genome strung from four random 25 bp blocks in random
    order: every block end is a branching node, so junction windows are
    dense and fill a small spool within a few dozen batches."""
    rng = np.random.default_rng(5)
    blocks = ["".join(rng.choice(list("ACGT"), 25)) for _ in range(4)]
    genome = "".join(blocks[i] for i in rng.integers(0, 4, 120))
    return simulate.shred(rng, genome, coverage=20, read_len=60,
                          err_rate=0.0, circular=True)


def test_a_flush_forced_mid_stream_spans_under_spool_append():
    """Two-read batches of 30 windows and a 16-lane update cap make
    Config's spool 128 lanes, flushed when a batch's lanes would pass 112
    (core/scan.py make_jspool, _spool_append). Junction-dense reads force
    flushes mid-stream: each is a spool_flush span under spool_append,
    counted in spool_flushes; the phase-end flush is one under flush."""
    from torch.profiler import ProfilerActivity, profile

    cfg = Config(size_kmer=31, max_read_length=60, batch_reads=2,
                 estimated_kmers=1 << 12, singletons=1 << 12,
                 junction_capacity=1 << 10, sink_capacity=1 << 12,
                 fp_rate=0.01, scan_update_cap=16)
    assert SC.make_jspool(cfg).khi.shape[0] == 128
    p = Pipeline(cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for bases, lens in _batches(_block_reads(), cfg)[:80]:
            p.stream_step(bases, lens)
    mid = p.metrics.tally["spool_flushes"]
    flushes = [e for e in _events(prof) if e[2].endswith("/spool_flush")]
    assert mid >= 1 and len(flushes) == mid
    assert {n for _, _, n in flushes} \
        == {"faucet.stream_step/scan_batch/spool_append/spool_flush"}
    assert not any(x.startswith("flush") for x in p.metrics.timers)
    p.flush_junctions()
    assert p.metrics.tally["spool_flushes"] == mid + 1
    assert "flush/spool_flush" in p.metrics.timers


def _count_reads(monkeypatch):
    """Counts every tensor-to-host conversion (Tensor.numpy, item,
    tolist, __int__, __bool__, __float__, __index__)."""
    n = [0]
    for name in ("numpy", "item", "tolist", "__int__", "__bool__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **kw):
            n[0] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return n


@pytest.mark.parametrize("k", [21, 55])
def test_scan_batch_reads_nothing_for_its_counters(reads, monkeypatch, k):
    """Pipeline.scan_batch makes exactly the blocking reads of the core
    scan (core/scan.py scan_batch) it wraps, each through fetch: its
    solid_windows and junction_hits, once two int() reads a batch, are
    device sums now, equal to those reads."""
    cfg = _cfg(k)
    batches = _batches(reads, cfg)
    p, twin = Pipeline(cfg, device="cpu"), Pipeline(cfg, device="cpu")
    for x in (p, twin):
        x.load_batches(batches)
    solid = junc = 0
    n = _count_reads(monkeypatch)
    for bases, lens in batches:
        before, syncs = n[0], p.metrics.tally.get("host_syncs", 0)
        p.scan_batch(bases, lens)
        mine = n[0] - before
        assert mine == p.metrics.tally["host_syncs"] - syncs > 0
        before = n[0]
        with twin.metrics.span("scan"):
            res = SC.scan_batch(
                twin.cascade, twin.junctions, twin.sinks,
                torch.from_numpy(bases), torch.from_numpy(lens), cfg=cfg,
                node_cascade=twin.node_cascade, jspool=twin.jspool)
        twin.junctions, twin.sinks = res.junctions, res.sinks
        if res.jspool is not None:
            twin.jspool = res.jspool
        assert n[0] - before == mine
        solid += int(res.n_solid)
        junc += int(res.n_junc_pos)
    monkeypatch.undo()
    assert p.metrics.counters["solid_windows"] == solid > 0
    assert p.metrics.counters["junction_hits"] == junc > 0


def test_an_assembly_keeps_its_phase_timers_and_the_build_adds_up(reads):
    p = Pipeline(_cfg(), device="cpu")
    p.run_file_mode(reads, reads)
    t = p.metrics.timers
    assert {"load", "scan", "build", "clean"} <= set(t)
    assert "walk" not in t
    parts = ("extract", "pass1", "pass2", "repair")
    assert sum(t[f"build/{x}"] for x in parts) == pytest.approx(t["build"],
                                                                rel=0.02)
    for ps in ("pass1", "pass2"):
        walk = t[f"build/{ps}/walk"]
        kids = sum(t.get(f"build/{ps}/walk/{x}", 0.0)
                   for x in ("round", "resolve", "collect", "sync"))
        assert kids == pytest.approx(walk, rel=0.02)
    tally = p.metrics.tally
    assert tally["walk_rounds"] > 0 and tally["walk_steps"] > 0
    assert tally["host_syncs"] > 0 and tally["table_probe_rounds"] > 0


def test_profile_trace_holds_the_spans(reads, tmp_path):
    simulate.write_fasta(str(tmp_path / "reads.fa"), reads)
    assert tcli.main([
        "-read_load_file", str(tmp_path / "reads.fa"), "-read_scan_file",
        str(tmp_path / "reads.fa"), "-size_kmer", "21", "-max_read_length",
        "100", "-estimated_kmers", str(1 << 15), "-singletons",
        str(1 << 15), "--batch_reads", "256", "--no_native", "--device",
        "cpu", "--profile", "-file_prefix", str(tmp_path / "prof")]) == 0
    events = json.loads((tmp_path / "prof.trace" / "trace.json")
                        .read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    for span in ("load", "load/load_batch", "scan/scan_batch/upsert/sync",
                 "build/extract", "build/pass1/walk/round",
                 "build/pass1/walk/resolve", "build/pass1/walk/collect",
                 "clean"):
        assert "faucet." + span in names, span
