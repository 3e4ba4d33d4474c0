#!/usr/bin/env python3
"""Run one benchmark cell of faucet_tpu_torch once, on one NVIDIA GPU.

    python3 benchmark/run.py --workload ecoli-k31.assemble --seed 7 \
        --seconds 45 --trace 0

A cell is a file under benchmark/workloads/ (named by the cell) that names
a configuration under benchmark/configs/ and the passes its traffic runs:

- "assemble": whole two-pass assemblies (Pipeline.load_batches,
  scan_batches, build, clean_graph), each with a fresh Pipeline, back to
  back over the same reads until the window has passed; the one in
  flight is finished and counts.
- "ingest": the single-pass stream (Pipeline.stream_step batch by batch,
  then flush_junctions) over whole datasets back to back, each with a
  fresh Pipeline; the dataset in flight at the close is finished after
  the window and is the one checked.

Set-up makes the genome and the reads on the card from --seed, loads (or,
in a checkout's first run, builds) the kernel library and warms the
cell's own shapes. With --trace 0 the last line of standard output is the
cell's end-to-end metrics (those that BENCHMARK.json declares for it,
of the window's readings and the device's memory peak); with --trace 1
it is its per-layer metrics, read by the small readers under
benchmark/metrics/ from the window's readings, spans, counters and a few
bounded profiler slices. Either way the run then checks what
the window produced against the plain reference (benchmark/check.py):
`correct`, with every number compared beside its limit, on the last
lines of standard error and under the result's last key, "limits".
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules the run may not hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "faucet_tpu", "bench")


def load_spec(cell: str, root: str = HERE) -> dict:
    """The workload file of a cell and the configuration it names."""
    with open(os.path.join(root, "workloads", f"{cell}.json")) as f:
        wl = json.load(f)
    with open(os.path.join(root, "configs", f"{wl['config']}.json")) as f:
        cfg = json.load(f)
    return {"cell": cell, "workload": wl, "config": cfg}


def declared_metrics(cell: str, path: str = os.path.join(ROOT,
                                                         "BENCHMARK.json")):
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that the
    cell reports: those without a "workloads" key, and those that list it."""
    with open(path) as f:
        bench = json.load(f)
    mine = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]
    return mine(bench["end_to_end"]), mine(bench["per_layer"])


def read_metric(name: str, ctx: dict, root: str = HERE):
    """The value benchmark/metrics/<name>.py reads from ctx, or None."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(root, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _note(msg: str):
    """A progress line on standard error, seconds since the start."""
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class DeviceClock:
    """When the work queued so far completes on the device, on the host's
    clock, read after the fact: mark() records a timing event; at() maps
    it onto time.perf_counter through an anchor event that the host saw
    complete (one synchronize) before the first mark. Nothing waits on
    the device while marks are taken. The anchor reads late by the
    wake-up of that one synchronize, some microseconds, the same for
    every mark. On the CPU the work is done when the call returns."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            torch.cuda.synchronize()
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
            self.anchor.synchronize()
        self.t0 = time.perf_counter()

    def mark(self):
        import torch

        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def at(self, mark) -> float:
        """The host time of a mark; its event has to have completed."""
        if not self.cuda:
            return mark
        return self.t0 + 1e-3 * self.anchor.elapsed_time(mark)


class _Cell:
    """What both drivers share: the reads, the program's Config."""

    def __init__(self, spec: dict, seed: int, device):
        from benchmark import gen, sizing
        from faucet_tpu_torch import Config

        self.spec, self.seed, self.device = spec, seed, device
        cfg = spec["config"]
        self.k, self.B = cfg["k"], cfg["batch_reads"]
        self.genome, self.reads = gen.make(cfg, seed, device)
        self.kw = sizing.program_kwargs(cfg, self.reads.n_reads)
        self.pcfg = Config(**self.kw)
        self.n_batches = self.reads.bases.shape[0] // self.B
        self.lens_np = self.reads.lens.cpu().numpy()
        self.ctx: dict = {"cell": spec["cell"]}
        self.last = None  # the Pipeline the check reads

    def pipeline(self):
        from faucet_tpu_torch import Metrics
        from faucet_tpu_torch.pipeline import Pipeline

        return Pipeline(self.pcfg, Metrics(), device=self.device)

    def batch(self, i: int):
        s = slice(i * self.B, (i + 1) * self.B)
        return self.reads.bases[s], self.lens_np[s]

    def state(self) -> dict:
        """The checked Pipeline's filters and tables, on the host."""
        from benchmark import check

        p = self.last
        f = {"a": p.cascade.a_bloom.words, "b": p.cascade.b_bloom.words}
        if p.node_cascade is not None:
            f["d"] = p.node_cascade.a_bloom.words
            f["e"] = p.node_cascade.b_bloom.words
        return {"filters": {n: w.cpu() for n, w in f.items()},
                "junctions": check.table_rows(p.junctions, "cpu"),
                "sinks": check.table_rows(p.sinks, "cpu")}

    def reference(self, hash_delta: int = 0, rows=None):
        """The plain reference over the checked dataset's batches; rows:
        the rows of each batch it reads (all by default)."""
        from benchmark.reference import Reference

        ref = Reference(self.kw, self.device, hash_delta)
        self.drive_reference(ref, rows)
        return ref

    def _ref_batches(self, rows):
        import torch

        for i in range(self.n_batches):
            bases, lens = self.batch(i)
            lens = torch.from_numpy(lens).to(self.device)
            if rows is not None:
                lens = lens.clone()
                lens[rows] = 0
            yield bases, lens


class Assemble(_Cell):
    """Whole two-pass assemblies, back to back."""

    def __init__(self, spec, seed, device):
        super().__init__(spec, seed, device)
        # the reads as a reader hands them over: host batches
        self.bases_np = self.reads.bases.cpu().numpy()

    def host_batches(self):
        bases = self.bases_np
        for i in range(self.n_batches):
            yield (bases[i * self.B:(i + 1) * self.B],
                   self.lens_np[i * self.B:(i + 1) * self.B])

    def assemble(self, hook=None):
        p = self.pipeline()
        if hook is not None:
            hook(p)
        p.load_batches(self.host_batches())
        p.scan_batches(self.host_batches())
        g = p.clean_graph(p.build())
        _sync(self.device)
        return p, [g.contigs[i].seq for i in g.live()]

    WARM_GENOME = 20_000  # bp of the warm-up assembly

    def warm(self):
        """Every kernel and torch op of an assembly on the cell's batch
        shape: one whole assembly of a 20 kbp genome of the same
        configuration (two batches of reads)."""
        cfg = dict(self.spec["config"], genome_len=self.WARM_GENOME)
        Assemble(dict(self.spec, config=cfg), self.seed,
                 self.device).assemble()

    def window(self, seconds: float, trace: bool):
        from benchmark import check
        from benchmark import trace as TR
        from faucet_tpu_torch.graph import walk as W

        times, timers, self.contigs = [], [], []
        walk = self.ctx["walk"] = {}
        name = "walk_round_wide" if self.pcfg.wide else "walk_round"
        if trace:
            sl = self.ctx["slices"] = {k: TR.Slices()
                                       for k in ("load", "scan", "walk")}
            orig = TR.walk_timer(W, name, walk, range(8, 12), sl["walk"])
        p = None
        t_end = time.perf_counter() + seconds
        try:
            while True:
                p = None
                hook = self._profile_hook if trace and not times else None
                w0 = walk.get("seconds", 0.0)
                t0 = time.perf_counter()
                p, contigs = self.assemble(hook)
                times.append(time.perf_counter() - t0)
                timers.append(dict(p.metrics.timers,
                                   walk=walk.get("seconds", 0.0) - w0))
                _note(f"assembly {len(times)}: {times[-1]:.3f} s, phases "
                      + ", ".join(f"{k} {v:.3f}"
                                  for k, v in timers[-1].items())
                      + f", {len(contigs)} contigs, N50 "
                      f"{check.n50([len(c) for c in contigs])}")
                self.contigs.append(contigs)
                if time.perf_counter() >= t_end:
                    break
        finally:
            if trace:
                setattr(W, name, orig)
        self.last = p
        self.attempted = len(times)
        # the profiled assembly's timers carry the profiler's cost
        self.ctx["assemblies"] = timers[1:] if len(timers) > 1 else timers
        return {"assembly_s": assembly_s(times)}

    def _profile_hook(self, p):
        """Profile load batches 4-7 and scan batches 4-7 of this
        Pipeline, each call inside a span of the benchmark's own."""
        import torch

        sl = self.ctx["slices"]
        for kind in ("load", "scan"):
            orig = getattr(p, f"{kind}_batch")
            calls = [0]

            def call(*a, _orig=orig, _kind=kind, _calls=calls, **kw):
                _calls[0] += 1
                n = _calls[0]
                if n == 4:
                    sl[_kind].start()
                with torch.profiler.record_function(f"bench.{_kind}_batch"):
                    out = _orig(*a, **kw)
                if n == 7:
                    sl[_kind].stop()
                return out

            setattr(p, f"{kind}_batch", call)

    def drive_reference(self, ref, rows):
        batches = list(self._ref_batches(rows))
        for bases, lens in batches:
            ref.load(bases, lens)
        for bases, lens in batches:
            ref.scan(bases, lens)


class Ingest(_Cell):
    """The single-pass stream over whole datasets, back to back."""

    PROFILED = range(20, 36)  # window batches inside the profiled slice

    def __init__(self, spec, seed, device):
        super().__init__(spec, seed, device)
        self.n_real = [int((self.batch(i)[1] > 0).sum())
                       for i in range(self.n_batches)]

    def warm(self):
        for _ in range(2):
            p = self.pipeline()
            for i in range(3):
                p.stream_step(*self.batch(i))
            p.flush_junctions()
            p = None
        _sync(self.device)

    def window(self, seconds: float, trace: bool):
        marks = []  # (hand-off, completion mark, reads) of every batch
        spans = self.ctx["batches"] = {"load_ms": [], "scan_ms": []}
        rec = sl = None
        if trace:
            from benchmark import roofline
            from benchmark import trace as TR

            sl = TR.Slices()
            self.ctx["slices"] = {"stream": sl}
            rec = self.ctx["recorder"] = roofline.Recorder()
        p, i, j = self._fresh(trace), 0, 0
        clock = DeviceClock(self.device)
        self.datasets = 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        try:
            while time.perf_counter() < t_end:
                if i == self.n_batches:
                    p.flush_junctions()
                    p = None
                    p, i = self._fresh(trace), 0
                    self.datasets += 1
                if trace and j == self.PROFILED[0]:
                    self._reserve()
                    sl.start()
                    rec.on = True
                self._step(p, i, trace, spans, j)
                marks.append((self._t_hand, clock.mark(), self.n_real[i]))
                if trace and j == self.PROFILED[-1]:
                    sl.stop()
                    rec.on = False
                i += 1
                j += 1
        finally:
            if sl is not None and sl.active:
                sl.stop()
            if rec is not None:
                rec.on = False
        # finish the dataset in flight, outside the window: it is checked
        while i < self.n_batches:
            p.stream_step(*self.batch(i))
            i += 1
        p.flush_junctions()
        _sync(self.device)
        if rec is not None:
            rec.close()
        self.last = p
        self.attempted = j
        done = [(h, clock.at(m), n) for h, m, n in marks]
        m = ingest_metrics(done, t_end, seconds)
        lat = sorted(d - h for h, d, _ in done)
        _note(f"{j} batches handed off, {self.datasets} whole datasets "
              f"before the close, {self.n_batches} batches each; batch "
              f"ms median {1e3 * lat[len(lat) // 2]:.3f}, p95 "
              f"{m['ingest_batch_p95_ms']:.3f}, max {1e3 * lat[-1]:.3f}")
        return m

    RESERVE_BYTES = 2 << 30

    def _reserve(self):
        """Grow the caching allocator by what the recorder will hold
        (~60 MB of call inputs a batch), so that no cudaMalloc falls
        inside the profiled slice."""
        import torch

        torch.empty((self.RESERVE_BYTES,), dtype=torch.uint8,
                    device=self.device)
        _sync(self.device)

    def _fresh(self, trace: bool):
        """A Pipeline for a new dataset; traced, its scan half is timed
        apart (host clock, closed by a synchronize)."""
        import torch

        p = self.pipeline()
        if trace:
            orig = p.scan_batch

            def scan_batch(*a, **kw):
                _sync(self.device)
                self._t_scan = time.perf_counter()
                with torch.profiler.record_function("bench.scan_batch"):
                    out = orig(*a, **kw)
                _sync(self.device)
                self._t_scan_end = time.perf_counter()
                return out

            p.scan_batch = scan_batch
        return p

    def _step(self, p, i, trace, spans, j):
        import torch

        self._t_hand = time.perf_counter()
        if not trace:
            p.stream_step(*self.batch(i))
            return
        with torch.profiler.record_function("bench.stream_step"):
            p.stream_step(*self.batch(i))
        if j not in self.PROFILED:
            spans["load_ms"].append(1e3 * (self._t_scan - self._t_hand))
            spans["scan_ms"].append(1e3 * (self._t_scan_end - self._t_scan))

    def drive_reference(self, ref, rows):
        for bases, lens in self._ref_batches(rows):
            ref.stream(bases, lens)


DRIVERS = {"assemble": Assemble, "ingest": Ingest}


def assembly_s(times) -> float:
    """Seconds per whole assembly: every assembly of the window (the one
    in flight at the close included), total over count."""
    return sum(times) / len(times)


def ingest_metrics(done, t_end: float, seconds: float) -> dict:
    """done: (hand-off, completion, reads) of every batch handed off in
    the window. Reads of the batches completed by the close over the
    window's seconds, and the 95th percentile of every batch's time from
    hand-off to completion on the device."""
    import numpy as np

    lat = [1e3 * (d - h) for h, d, _ in done]
    return {"reads_per_s": sum(n for _, d, n in done if d <= t_end)
            / seconds,
            "ingest_batch_p95_ms": float(np.percentile(lat, 95))}


def check_numbers(cell: _Cell, prog: dict, ref) -> dict:
    """Every number compared: the load and scan layers against the
    reference and, where the cell assembles, each assembly's contigs
    against the genome (the worst assembly's reading)."""
    from benchmark import check, gen

    nums = check.state_numbers(prog, ref)
    chunk = gen.chunk_len(cell.spec["config"])
    for contigs in getattr(cell, "contigs", []):
        for n, v in check.contig_numbers(contigs, cell.genome, cell.k,
                                         chunk).items():
            nums[n] = max(nums.get(n, v), v)
    return nums


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device="cuda", per_layer=None) -> dict:
    """Set up, run the window, read the metrics and check the outputs;
    returns the result line's fields. per_layer: the per-layer metric
    entries a traced run reads."""
    import torch

    from benchmark import check
    from faucet_tpu_torch.kernels import build as KB

    cuda = torch.device(device).type == "cuda"
    if cuda:
        KB.library()
    _note("kernel library loaded")
    cell = DRIVERS[spec["workload"]["passes"]](spec, seed, device)
    _sync(device)
    _note(f"{cell.reads.n_reads} reads of a {cell.genome.shape[0]} bp "
          "genome made")
    cell.warm()
    _sync(device)
    setup_s = time.perf_counter() - T_START
    _note(f"warmed up; set-up {setup_s:.3f} s")
    metrics = cell.window(seconds, trace)
    out = {"peak": torch.cuda.max_memory_allocated() if cuda else 0}
    metrics["device_peak_gib"] = out["peak"] / 2 ** 30
    cell.ctx["window"] = metrics
    prog = cell.state()
    cell.last = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _note(f"window closed; {cell.attempted} attempted")
    numbers = check_numbers(cell, prog, cell.reference())
    _note("reference compared")
    out.update(correct=check.verdict(numbers), attempted=cell.attempted)
    out["failed"] = 0 if out["correct"] else cell.attempted
    if trace:
        vals = {m["name"]: read_metric(m["name"], cell.ctx)
                for m in per_layer or ()}
        out["metrics"] = {m["name"]: {"value": vals[m["name"]],
                                      "unit": m["unit"]}
                          for m in per_layer or () if vals[m["name"]]
                          is not None}
        from benchmark import trace as TR

        sl = TR.merged(cell.ctx["slices"].values())
        out["trace"] = {"busy_s": sl.busy_s(), "window_s": sl.window_s,
                        "breakdown": sl.breakdown()}
    else:
        out["metrics"] = dict(metrics, setup_s=setup_s)
    out["numbers"] = numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    e2e, per_layer = declared_metrics(args.workload)
    chips = spec["workload"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                   per_layer=per_layer)
    units = {m["name"]: m["unit"] for m in e2e}
    if not args.trace:
        res["metrics"] = {n: {"value": v, "unit": units[n]}
                          for n, v in res["metrics"].items() if n in units}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": res["peak"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        device.update(busy_s=res["trace"]["busy_s"],
                      window_s=res["trace"]["window_s"])
        line["breakdown"] = res["trace"]["breakdown"]
    from benchmark import check

    line["limits"] = check.limits_line(res["numbers"])
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(BANNED))
    if found:
        print(f"modules that may not be loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for n, v in line["limits"].items():
        print(f"check {n}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
