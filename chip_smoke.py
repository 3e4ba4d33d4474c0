#!/usr/bin/env python3
"""Smoke run of faucet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py             # all phases, one card, ~10 minutes

Phases (each prints its seconds; any failure raises and exits non-zero):
  1 device    torch.cuda must be available; prints the card's name and
              power limit as nvidia-smi reports them
  2 build     nvcc builds the CUDA kernels from faucet_tpu_torch/csrc
  3 kernels   each kernel against its plain torch version on the same
              CUDA inputs at the main path's shapes: bit-identical, with
              median times (CUDA events)
  4 parity    the port's Pipeline on ~50 kbp of repeat-genome reads, once
              on the CPU (plain versions) and once on CUDA (kernels):
              identical contigs, junction and sink tables
  5 scale     2 Mbp genome with repeats, 30x 100 bp reads at 0.5% error,
              bench/scale_run.py's configuration, two-pass file mode:
              18 contigs, N50 221,925, 1,997,960 bases (the record
              bench/scale_r5_2mb.json) and >= 99% genome-true bases
  6 cli       python -m faucet_tpu_torch.cli on 0.5 Mbp of reads, two-pass
              and --stream: FASTA, GFA and both checkpoints written,
              contigs genome-true
  7 stream    bench.py's configuration, Pipeline.stream_step over 16
              batches of 8192 reads: load+scan reads/s
  8 counters  every kernel launched during phases 5 and 7

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
PHASES = ("device", "build", "kernels", "parity", "scale", "cli", "stream",
          "counters")

# bench/scale_r5_2mb.json: the reference's 2 Mbp assembly
SCALE_MBP = 2.0
SCALE_RECORD = {"contigs": 18, "n50": 221925, "total": 1997960}

report = {"phases": {}}


def log(msg: str):
    print(msg, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            log(f"[{name}] start")
            rec = report["phases"].setdefault(name, {})
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            dt = time.perf_counter() - t0
            rec["seconds"] = dt
            log(f"[{name}] done in {dt:.2f} s")
            return r
        return run
    return wrap


# ---- helpers ----------------------------------------------------------------

def n50(lengths) -> int:
    s = np.sort(np.asarray(lengths))[::-1]
    c = np.cumsum(s)
    return int(s[np.searchsorted(c, c[-1] / 2)])


def genome_true_frac(contigs, genome: str) -> float:
    """Share of contig bases in contigs that are exact substrings of the
    circular genome (genome + genome) or its reverse complement."""
    from faucet_tpu_torch.core.kmer import revcomp_seq

    gg = genome + genome
    hay = gg + "\x00" + revcomp_seq(gg)
    tot = sum(len(c) for c in contigs)
    good = sum(len(c) for c in contigs if c in hay)
    return good / max(tot, 1)


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events; setup()
    runs before each rep outside the timed region."""
    import torch

    times = []
    for _ in range(reps):
        args = setup() if setup else ()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def launch_loop_ms(launch, reps: int = 50) -> float:
    """Device milliseconds per launch of a raw kernel launcher: reps
    back-to-back launches between two CUDA events (a ctypes launch costs
    the host a few us, so the device, not the host, sets the pace)."""
    import torch

    launch()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_share(fn):
    """Run fn under torch.profiler. Returns (wall s, summed kernel time s,
    top kernels [(us, name, count)]); one stream, so kernels never
    overlap and their sum is the device's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            rows.append((us, e.key[:60], e.count))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows) / 1e6, rows[:8]


def log_share(tag, wall, dev, top):
    rec = {"wall_s": wall, "device_s": dev,
           "busy_share": dev / wall if wall else None,
           "top_kernels": [list(r) for r in top]}
    if dev:
        log(f"{tag} under the profiler: wall {wall:.3f} s, kernels "
            f"{dev:.3f} s, device busy {dev / wall:.3f}")
        for us, name, cnt in top:
            log(f"    {us / 1e3:9.2f} ms  x{cnt:<6} {name}")
    else:
        log(f"{tag}: the profiler reported no device time (not measured)")
    return rec


def scale_config(genome_len: int, n_reads: int):
    """bench/scale_run.py's configuration (k=31, 100 bp, 8192/batch)."""
    from faucet_tpu_torch import Config

    k = 31
    n_kmers = genome_len - k + 1
    return Config(size_kmer=k, max_read_length=100, batch_reads=8192,
                  estimated_kmers=n_kmers,
                  singletons=int(n_reads * 100 * 0.005 * k) + n_kmers,
                  junction_capacity=1 << 20, sink_capacity=4 * n_kmers,
                  fp_rate=0.01)


def scale_reads():
    """bench/scale_run.py's reads: repeat genome, 30x, 100 bp, 0.5%
    errors, circular, numpy default_rng(0)."""
    from faucet_tpu_torch import simulate as SIM

    G = int(SCALE_MBP * 1e6)
    rng = np.random.default_rng(0)
    genome = SIM.genome_with_repeats(rng, G, n_repeats=max(4, G // 250_000),
                                     repeat_len=400)
    reads = SIM.shred(rng, genome, coverage=30.0, read_len=100,
                      err_rate=0.005, circular=True)
    return genome, reads


# ---- phases -----------------------------------------------------------------

@phase("device")
def run_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda is not available: this smoke needs "
                           "an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    report["device"] = info
    log(f"torch {info['torch']} cuda {info['cuda']}; "
        f"{info['count']} device(s)")
    return smi


@phase("build")
def run_build():
    from faucet_tpu_torch.kernels import build as KB

    KB.library()
    log(f"library {KB.library_path().name}: built in "
        f"{KB.build_seconds if KB.build_seconds is not None else 0:.2f} s"
        f" (0 = already on disk)")
    for line in KB.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())
    report["phases"]["build"]["log"] = KB.build_log


def _rand_keys(gen, n, dev):
    import torch

    hi = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev)
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=dev)
    return hi, lo


@phase("kernels")
def run_kernels():
    import torch

    from faucet_tpu_torch.core import bloom as BL
    from faucet_tpu_torch.kernels import cascade as KC
    from faucet_tpu_torch.kernels import probe as KP

    from faucet_tpu_torch.kernels import build as KB

    lib = KB.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    res = {}

    # -- probe: a half-full 4 MB filter (B/E), file-mode window probe
    #    (8192 reads x 70 windows) and the two stacked E-probes
    words = torch.randint(-(1 << 31), 1 << 31, (1 << 20,), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    for n in (573_440, 1_146_880):
        hi, lo = _rand_keys(gen, n, dev)
        block, h1r, h2 = BL._block_h1r_h2(hi, lo, 25)
        live = torch.rand((n,), generator=gen, device=dev) < 0.9
        block = torch.where(live, block, KP.SENTINEL)
        got = KP.bloom_probe_keys(words, block, h1r, h2, 3)
        want = KP.bloom_probe_keys_plain(words, block, h1r, h2, 3)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if err:
            raise AssertionError(f"probe kernel != plain at N={n}")
        k_ms = cuda_ms(lambda: KP.bloom_probe_keys(words, block, h1r, h2,
                                                   3), 20)
        p_ms = cuda_ms(lambda: KP.bloom_probe_keys_plain(words, block, h1r,
                                                         h2, 3), 20)
        out = torch.empty_like(got)
        d_ms = launch_loop_ms(lambda: KB.check(lib.ft_bloom_probe(
            words.data_ptr(), words.shape[0], block.data_ptr(),
            h1r.data_ptr(), h2.data_ptr(), out.data_ptr(), n, 3,
            KB.stream_of(words)), "probe"))
        hits = float(want.float().mean())
        log(f"probe N={n}: identical (hit rate {hits:.3f}); per call: "
            f"wrapper {k_ms * 1e3:.1f} us (kernel alone {d_ms * 1e3:.1f} "
            f"us), plain {p_ms * 1e3:.1f} us")
        res[f"probe_{n}"] = {"ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                             "max_abs_err": err}

    # -- cascade: A 16 MB, B 4 MB (the 2 Mbp load), two batches of
    #    573,440 keys with in-batch duplicates; then the sparse node
    #    insert: D 16 MB, E 4 MB, 1,146,880 lanes, ~3% live
    def check_cascade(tag, la, lb, nha, nhb, batches):
        a = torch.zeros((1 << (la - 5),), dtype=torch.int32, device=dev)
        b = torch.zeros((1 << (lb - 5),), dtype=torch.int32, device=dev)
        ap, bp = a.clone(), b.clone()
        times = []
        for bi, (hi, lo, live) in enumerate(batches):
            h1, h2 = BL.hash_pair(hi, lo)
            ba, h1r, h2 = BL._block_from_hash(h1, h2, la)
            bb, _, _ = BL._block_from_hash(h1, h2, lb)
            ba = torch.where(live, ba, KC.SENTINEL)
            args = (hi, lo, ba, bb, h1r, h2, nha, nhb)
            # time on copies of the pre-batch state, then apply for real
            k_ms = cuda_ms(KC.cascade_insert, 10,
                           setup=lambda: (a.clone(), b.clone()) + args)
            p_ms = cuda_ms(KC.cascade_insert_plain, 5,
                           setup=lambda: (ap.clone(), bp.clone()) + args)
            d_ms = apply_ms(a.clone(), b.clone(), args)
            nb, sol = KC.cascade_insert(a, b, *args)
            nbp, solp = KC.cascade_insert_plain(ap, bp, *args)
            torch.cuda.synchronize()
            err = max(int((a.long() - ap.long()).abs().max()),
                      int((b.long() - bp.long()).abs().max()),
                      int((nb.int() - nbp.int()).abs().max()),
                      int((sol.int() - solp.int()).abs().max()))
            if err:
                raise AssertionError(f"cascade kernel != plain ({tag}, "
                                     f"batch {bi})")
            log(f"cascade {tag} batch {bi}: identical (new_b "
                f"{int(nb.sum())}, solid {int(sol.sum())}); per call: "
                f"wrapper {k_ms * 1e3:.1f} us (apply kernel alone "
                f"{d_ms * 1e3:.1f} us), plain {p_ms * 1e3:.1f} us")
            times.append({"ms": k_ms, "apply_device_ms": d_ms,
                          "plain_ms": p_ms, "max_abs_err": err})
        return times

    def apply_ms(a, b, args):
        """The apply kernel alone, re-applied to one sorted batch (OR is
        idempotent, so every launch does the same work)."""
        hi, lo, ba, bb, h1r, h2, nha, nhb = args
        probe = lambda qa, qb, r1, r2: (
            KP.bloom_probe_keys(a, qa, r1, r2, nha),
            KP.bloom_probe_keys(b, qb, r1, r2, nhb))
        sa, sb, r1, r2, sidx, seg, in_a, in_b = KC._sorted_batch(
            hi, lo, ba, bb, h1r, h2, probe)
        nb = torch.empty_like(in_a)
        sol = torch.empty_like(in_a)
        return launch_loop_ms(lambda: KB.check(lib.ft_cascade_apply(
            a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0],
            sa.data_ptr(), sb.data_ptr(), r1.data_ptr(), r2.data_ptr(),
            seg.data_ptr(), in_a.data_ptr(), in_b.data_ptr(),
            sidx.data_ptr(), nb.data_ptr(), sol.data_ptr(), sa.shape[0],
            nha, nhb, KB.stream_of(a)), "apply"), reps=20)

    n = 573_440
    pool_hi, pool_lo = _rand_keys(gen, 300_000, dev)

    def dense_batch():
        pick = torch.randint(0, 300_000, (n,), generator=gen, device=dev)
        return (pool_hi[pick], pool_lo[pick],
                torch.rand((n,), generator=gen, device=dev) < 0.97)

    for nha in (4, 7):
        res[f"cascade_dense_{nha}_3"] = check_cascade(
            f"dense n_hash {nha}/3", 24, 22, nha, 3,
            [dense_batch(), dense_batch()])
    ns = 1_146_880
    hi, lo = _rand_keys(gen, ns, dev)
    hi = hi | (torch.randint(0, 2, (ns,), generator=gen, device=dev) << 30)
    live = torch.rand((ns,), generator=gen, device=dev) < 0.03
    # the same live lanes twice: the second pass promotes them into E
    res["cascade_sparse_3_3"] = check_cascade("sparse 3/3", 24, 22, 3, 3,
                                              [(hi, lo, live)] * 2)
    report["kernels"] = res
    return res


def _table_arrays(t):
    from faucet_tpu_torch.ckpt import state as CK

    d = CK.table_to_numpy(t)
    return [d["keys_hi"], d["keys_lo"], *d["vals"], d["count"],
            d["dropped"]]


@phase("parity")
def run_parity():
    from faucet_tpu_torch import Config
    from faucet_tpu_torch import simulate as SIM
    from faucet_tpu_torch.pipeline import Pipeline

    rng = np.random.default_rng(777)
    genome = SIM.genome_with_repeats(rng, 50_000, n_repeats=2,
                                     repeat_len=200)
    reads = SIM.shred(rng, genome, coverage=40, read_len=100,
                      err_rate=0.005, circular=True)
    cfg = Config(size_kmer=21, max_read_length=100, batch_reads=2048,
                 estimated_kmers=1 << 16, singletons=1 << 17,
                 junction_capacity=1 << 14, sink_capacity=1 << 17,
                 fp_rate=0.002)
    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        p = Pipeline(cfg, device=dev)
        g = p.run_file_mode(reads, reads)
        out[dev] = (sorted(g.contigs[i].canonical_seq() for i in g.live()),
                    _table_arrays(p.junctions), _table_arrays(p.sinks))
        log(f"{dev}: {len(out[dev][0])} contigs in "
            f"{time.perf_counter() - t0:.2f} s")
    (ca, ja, sa), (cb, jb, sb) = out["cpu"], out["cuda"]
    if ca != cb:
        raise AssertionError("CPU and CUDA contig sets differ")
    for x, y in zip(ja + sa, jb + sb):
        if not np.array_equal(x, y):
            raise AssertionError("CPU and CUDA junction/sink tables differ")
    frac = genome_true_frac([c for c in cb], genome)
    log(f"identical assemblies: {len(cb)} contigs, genome-true {frac:.5f}")
    report["phases"]["parity"].update(contigs=len(cb), genome_true=frac)


def _walk_timer(profile_round=None):
    """Wrap graph.walk.walk_round to count rounds/steps and time them
    (one synchronize per round of 64-256 steps). Round `profile_round`
    runs under the profiler instead and is left out of the counts."""
    import torch

    from faucet_tpu_torch.graph import walk as W

    st = {"rounds": 0, "steps": 0, "lane_steps": 0, "seconds": 0.0}
    orig = W.walk_round

    def timed(cascade, junctions, fr, n_steps, cfg, **kw):
        st["rounds"] += 1
        if st["rounds"] == profile_round:
            out = []
            st["profiled_round"] = log_share(
                f"walk round {profile_round} ({n_steps} steps x "
                f"{fr.steps.shape[0]} lanes)", *device_share(
                    lambda: out.append(orig(cascade, junctions, fr, n_steps,
                                            cfg, **kw))))
            return out[0]
        t0 = time.perf_counter()
        r = orig(cascade, junctions, fr, n_steps, cfg, **kw)
        torch.cuda.synchronize()
        st["seconds"] += time.perf_counter() - t0
        st["steps"] += n_steps
        st["lane_steps"] += n_steps * fr.steps.shape[0]
        return r

    return orig, timed, st


@phase("scale")
def run_scale(profile: bool = False):
    import torch

    from faucet_tpu_torch import Metrics
    from faucet_tpu_torch.graph import walk as W
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    t0 = time.perf_counter()
    genome, reads = scale_reads()
    log(f"{SCALE_MBP} Mbp genome, {len(reads)} reads synthesized in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = scale_config(len(genome), len(reads))
    p = Pipeline(cfg, Metrics(), device="cuda")
    ph = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        ph[name] = time.perf_counter() - t
        log(f"  {name}: {ph[name]:.2f} s")
        return r

    orig, wrapped, wst = _walk_timer(20 if profile else None)
    W.walk_round = wrapped
    try:
        timed("load", lambda: p.load_batches(batch_iter(reads, cfg)))
        timed("scan", lambda: p.scan_batches(batch_iter(reads, cfg)))
        g = timed("graph_build", p.build)
        g = timed("clean", lambda: p.clean_graph(g))
    finally:
        W.walk_round = orig
    contigs = [g.contigs[i].seq for i in g.live()]
    lens = [len(c) for c in contigs]
    got = {"contigs": len(contigs), "n50": n50(lens), "total": sum(lens)}
    frac = genome_true_frac(contigs, genome)
    ms_step = 1e3 * wst["seconds"] / max(wst["steps"], 1)
    log(f"assembly {got}, genome-true {frac:.5f}; walk: {wst['rounds']} "
        f"rounds, {wst['steps']} steps timed in {wst['seconds']:.2f} s, "
        f"{ms_step:.3f} ms/step")
    report["phases"]["scale"].update(mbp=SCALE_MBP, phase_s=ph, walk=wst,
                                     walk_ms_per_step=ms_step,
                                     genome_true=frac, **got)
    if got != SCALE_RECORD:
        raise AssertionError(f"assembly {got} != record {SCALE_RECORD}")
    if frac < 0.99:
        raise AssertionError(f"genome-true {frac:.5f} < 0.99")


@phase("cli")
def run_cli():
    from faucet_tpu_torch import simulate as SIM
    from faucet_tpu_torch.out.fasta import read_fasta

    rng = np.random.default_rng(5)
    genome = SIM.genome_with_repeats(rng, 500_000, n_repeats=4,
                                     repeat_len=400)
    reads = SIM.shred(rng, genome, coverage=30.0, read_len=100,
                      err_rate=0.005, circular=True)
    cfg = scale_config(len(genome), len(reads))
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "reads.fa")
        SIM.write_fasta(fa, reads)
        for mode in ("two_pass", "stream"):
            prefix = os.path.join(d, mode)
            cmd = [sys.executable, "-m", "faucet_tpu_torch.cli",
                   "-read_load_file", fa, "-size_kmer", "31",
                   "-max_read_length", "100",
                   "-estimated_kmers", str(cfg.estimated_kmers),
                   "-singletons", str(cfg.singletons),
                   "--batch_reads", "8192", "-file_prefix", prefix]
            cmd += (["--stream"] if mode == "stream"
                    else ["-read_scan_file", fa])
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=REPO, capture_output=True,
                               text=True, timeout=600)
            if r.returncode:
                raise RuntimeError(f"cli {mode} failed ({r.returncode}):\n"
                                   + r.stderr[-3000:])
            for ext in ("fasta", "gfa", "bloom.npz", "junctions.npz"):
                if not os.path.getsize(f"{prefix}.{ext}"):
                    raise AssertionError(f"cli {mode}: empty {ext}")
            contigs = [s for _, s in read_fasta(f"{prefix}.fasta")]
            frac = genome_true_frac(contigs, genome)
            native = "native C++ reader" in r.stderr
            log(f"{mode}: {len(contigs)} contigs, N50 "
                f"{n50([len(c) for c in contigs])}, genome-true "
                f"{frac:.5f}, {time.perf_counter() - t0:.2f} s"
                f"{' (native reader)' if native else ''}")
            if frac < 0.99:
                raise AssertionError(f"cli {mode}: genome-true {frac}")
            report["phases"]["cli"][mode] = {
                "contigs": len(contigs), "genome_true": frac,
                "seconds": time.perf_counter() - t0}


@phase("stream")
def run_stream(n_batches: int = 16, warmup: int = 2, profile: bool = False):
    import torch

    from faucet_tpu_torch import Config, Metrics
    from faucet_tpu_torch.pipeline import Pipeline

    # bench.py's configuration (bench.py build())
    cfg = Config(size_kmer=31, max_read_length=100, batch_reads=8192,
                 estimated_kmers=2_000_000, singletons=8_000_000,
                 junction_capacity=1 << 18, sink_capacity=1 << 21,
                 fp_rate=0.01)
    B, L, G = cfg.batch_reads, cfg.max_read_length, 2_000_000
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, G + L, dtype=np.uint8)
    batches = []
    for _ in range(warmup + n_batches):
        starts = rng.integers(0, G, B)
        b = genome[starts[:, None] + np.arange(L)[None, :]]
        flip = rng.random(B) < 0.5
        b[flip] = (3 - b[flip])[:, ::-1]
        err = rng.random((B, L)) < 0.005
        b[err] = rng.integers(0, 4, int(err.sum()))
        batches.append((torch.from_numpy(b).cuda(),
                        np.full(B, L, np.int32)))
    p = Pipeline(cfg, Metrics(), device="cuda")
    for bases, lens in batches[:warmup]:
        p.stream_step(bases, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bases, lens in batches[warmup:]:
        p.stream_step(bases, lens)
    p.flush_junctions()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = n_batches * B / dt
    log(f"{n_batches} batches x {B} reads in {dt:.3f} s: {rate:.0f} "
        f"reads/s (load+scan, after {warmup} warmup batches)")
    report["phases"]["stream"].update(reads_per_s=rate, seconds_timed=dt,
                                      batches=n_batches)
    if profile:
        report["phases"]["stream"]["profiled"] = log_share(
            "4 stream batches", *device_share(
                lambda: [p.stream_step(b, n) for b, n in batches[-4:]]))


def kernel_line(launches):
    k = report.get("kernels", {})
    probe = k.get("probe_573440", {})
    casc = (k.get("cascade_dense_4_3") or [{}])[0]
    errs = [v["max_abs_err"] for key, v in k.items()
            if key.startswith("probe")]
    cerrs = [t["max_abs_err"] for key, v in k.items()
             if key.startswith("cascade") for t in v]
    return {"kernels": [
        {"name": "bloom_probe", "route": "cuda",
         "source": "faucet_tpu_torch/csrc/probe.cu",
         "replaces": "faucet_tpu/kernels/probe.py:98",
         "launches": launches["probe"],
         "max_abs_err": max(errs) if errs else None,
         "ms": probe.get("ms"), "plain_ms": probe.get("plain_ms")},
        {"name": "cascade_insert", "route": "cuda",
         "source": "faucet_tpu_torch/csrc/cascade.cu",
         "replaces": "faucet_tpu/kernels/cascade.py:470",
         "launches": launches["cascade"],
         "max_abs_err": max(cerrs) if cerrs else None,
         "ms": casc.get("ms"), "plain_ms": casc.get("plain_ms")}]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also run one walk round and 4 stream batches "
                         "under torch.profiler (device busy share)")
    args = ap.parse_args(argv)
    want = args.phases.split(",")
    sys.path.insert(0, REPO)
    t_all = time.perf_counter()

    smi = run_device()
    if "build" in want:
        run_build()
    if "kernels" in want:
        run_kernels()
    if "parity" in want:
        run_parity()

    from faucet_tpu_torch.kernels import cascade as KC
    from faucet_tpu_torch.kernels import probe as KP

    # the main path's launches: counted from here to the end of phase 7
    KP.launches = KC.launches = 0
    if "scale" in want:
        run_scale(args.profile)
    if "cli" in want:
        run_cli()
    if "stream" in want:
        run_stream(profile=args.profile)
    launches = {"probe": KP.launches, "cascade": KC.launches}
    log(f"[counters] main-path launches: {launches}")
    if "counters" in want and not all(launches.values()):
        raise AssertionError(f"a kernel was never launched: {launches}")

    import torch

    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"total {report['seconds']:.1f} s")
    print(smi)
    print(json.dumps(kernel_line(launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
