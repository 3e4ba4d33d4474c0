#!/usr/bin/env python3
"""Smoke run of faucet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py             # all phases, one card, ~12 minutes

Independent work runs side by side, each part in a process of its own,
to keep the whole run well inside its time limit: phase 4's CPU runs
beside its CUDA runs, phase 6b beside phase 6, phase 7's CLI runs (and
the dist phase's part (d)) together, and the dist phase's part (b)
beside its part (a). Progress lines, with the seconds since the start,
go to standard error.

Phases (each prints its seconds; any failure raises and exits non-zero):
  1 device    torch.cuda must be available; prints the card's name and
              power limit as nvidia-smi reports them
  2 build     nvcc builds the CUDA kernels from faucet_tpu_torch/csrc
  3 kernels   each kernel against its plain torch version on the same
              CUDA inputs at the main path's shapes: bit-identical, with
              median times (CUDA events) of the wrapper, the kernel alone
              and the plain version, the bound from the shapes and the
              share of it achieved; B7 also at its callers' shapes and
              over 1,000 back-to-back calls of changing size (epoch
              reuse), with torch.nonzero_static beside it as a yardstick;
              B1, B2-B4 and B7 also at the k = 55 path's shapes; B6 also
              on unaligned, short and past-the-end inputs; the wide
              scan's extension keys (csrc/wide_ext.cu) at 8,192 x 46; the
              hash table's updates (csrc/table_upsert.cu) at a k = 55
              stream batch's sink and junction updates
  3b entries  the scatter-OR kernels' entry points (no caller on the main
              path), core/bloom.bloom_insert and scatter_or_bits: timed,
              then driven and counted, CUDA == CPU; they use only the API
              that earlier trees share, so --root runs them there too
  4 parity    the port's Pipeline on ~50 kbp of repeat-genome reads, once
              on the CPU (plain versions, in a process of their own) and
              once on CUDA (kernels), at k = 21 and at k = 55, in Bloom
              mode and in exact mode, and
              with prune_slot_cov = 2 at k = 21: identical contigs,
              junction and sink tables (code-word columns included) and,
              in exact mode, cascade and node-cascade tables; walk ms
              per step of each mode on CUDA
  5 scale     2 Mbp genome with repeats, 30x 100 bp reads at 0.5% error,
              bench/scale_run.py's configuration, two-pass file mode:
              18 contigs, N50 221,925, 1,997,960 bases (the record
              bench/scale_r5_2mb.json) and >= 99% genome-true bases
  6 paired    the phased repeat of tests/golden/test_pairs.py on the CPU
              and on CUDA (identical, both phase it); then the 2 Mbp
              genome as 600,000 mate pairs, paired two-pass file mode:
              the reference's record PAIRED_RECORD, >= 99% genome-true
  6b wide     (in a process of its own beside phase 6, with its own
              launch counts) k = 55 (wide codes, 8-way extension probe)
              on the same genome as 30x 150 bp reads, two-pass file mode:
              the reference's record WIDE_RECORD, >= 99% genome-true; B1
              lanes per scan batch, peak device memory
  6c dualk    configuration 2 (BASELINE.md): phase 5's k = 31 graph (built
              here if phase 5 did not run), chunked to 100 bp
              (contig_chunks), then a second pass at k = 55 over the
              reads and the chunks, as the CLI's -second_kmer runs it: the
              reference's record DUALK_RECORD, >= 99% genome-true; chunk
              count, phase seconds, walk ms per step, peak device memory
  6d          (with phase 3) B1, B2 and B7 against their plain versions
              at the second pass's own shapes and live shares, from a
              census of its load and scan: the window and 8-way extension
              probes (8,192 x 46, 8,192 x 46 x 8), the load batch (376,832
              keys) into its filters, the compaction at cap = N
  7 cli       (its runs all at once, each a process of its own, with part
              (d) of phase 8b when that phase runs) python -m
              faucet_tpu_torch.cli on 0.5 Mbp of reads, two-pass,
              --stream, --paired_ends two-pass and -size_kmer 55 two-pass:
              FASTA, GFA and both checkpoints written, contigs
              genome-true; two-pass and
              paired cover >= 99% of the genome, and paired equals the
              reference's CLI_PAIRED_RECORD; then -size_kmer 31
              -second_kmer 55 --profile on phase 4's reads, fed on stdin:
              the spool and second-pass lines, no spool file left,
              genome-true, and a Chrome trace holding the probe, cascade
              and compaction kernels (by their names in csrc/)
  8 stream    bench.py's configuration, Pipeline.stream_step over 16
              batches of 8192 reads: load+scan reads/s; then 20 runs in
              ABBA order, the upsert rounds compacted by the kernel or by
              its plain version: identical tables, medians and quartiles
  8b dist     hash-range sharding, one process per shard: (a) the 2 Mbp
              scale cell at 4 gloo ranks sharing the card (SCALE_RECORD,
              tables' content = one device's, collectives, routed bytes,
              walk ms/step, launches per rank), (b) phase 4's cases and
              the phased repeat at 4 CPU ranks = 4 card ranks, (c) nccl
              at one rank = Pipeline, (d) the --n_shards 4 CLI on phase
              7's reads = the reference's sharded FASTA, (e) B1, B2, B7
              at (a)'s shard shapes (--dist_parts picks parts)
  9 counters  every main-path kernel launched in each of the scale,
              paired, wide, dualk, stream and dist paths (counts set to 0 just
              before each path and read just after it, from the tallies'
              `<kernel>_launches`, which kernels/build.py counts; a --root
              tree from before that counts in module globals and reports
              no launch counts, so its gates see none); phase 4's exact
              run at k = 21 on CUDA launches the compaction and the
              table upsert and no probe or cascade kernel; device
              launches of one
              membership query, one compaction and one bloom_insert (1
              each) and one cascade insert (at most 3), from
              torch.profiler after the timed phases

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Imports nothing of JAX, nor of faucet_tpu.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ROOT = REPO  # where faucet_tpu_torch is imported from (--root)
OUT_DIR = os.path.join(REPO, "chiprun_out")
PHASES = ("device", "build", "kernels", "entries", "parity", "scale",
          "paired", "wide", "dualk", "cli", "stream", "dist", "counters")

# bench/scale_r5_2mb.json: the reference's 2 Mbp assembly
SCALE_MBP = 2.0
SCALE_RECORD = {"contigs": 18, "n50": 221925, "total": 1997960}
# the reference (faucet_tpu on the JAX CPU backend) on the same genome
# shred into 600,000 mate pairs, paired two-pass file mode (PERF.md)
PAIRED_RECORD = {"contigs": 18, "n50": 221925, "total": 1997960,
                 "disentangled": 0, "pair_keys": 27579, "junctions": 19695,
                 "sinks": 1557128}

# phase 7's mates are drawn with their own seed; the reference's CLI
# (faucet_tpu on the JAX CPU backend) assembles 99.8% of the genome from
# them. (Other seeds lose whole repeat-bounded segments in the
# reference's bubble popping, ROADMAP.md C; the port mirrors it.)
CLI_MATES_SEED = 8
CLI_PAIRED_RECORD = {"contigs": 8, "n50": 99741, "total": 499137}

report = {"phases": {}, "launches_by_path": {}, "cascade_variants_by_path": {}}


T_START = time.perf_counter()


LOG_TAG = ""  # prefixes the lines of a phase run in a process of its own


def log(msg: str):
    print(LOG_TAG + msg, flush=True)


def note(msg: str):
    """A progress line on standard error, with the seconds since the
    start: where a run that is stopped got to."""
    print(f"[smoke {time.perf_counter() - T_START:.1f} s] {msg}",
          file=sys.stderr, flush=True)


def _kernel_module(name: str):
    """faucet_tpu_torch.kernels.<name>, or None in a tree without it
    (--root)."""
    import importlib

    try:
        return importlib.import_module(f"faucet_tpu_torch.kernels.{name}")
    except ImportError:
        return None


# the Metrics that the counted paths' Pipelines run with (counted_metrics):
# kernels/build.py counts each launch in the tally of the innermost open
# span's Metrics, a Pipeline's own, or the process default's outside
# every span
_COUNTED = []
# the main path's kernels by their tally keys (`<kernel>_launches`)
MAIN_KERNELS = ("probe", "cascade", "compact", "upsert")


def counted_metrics():
    """A Metrics for a Pipeline whose launches the smoke counts (each
    zero_counts sets them to 0 again)."""
    from faucet_tpu_torch import Metrics

    m = Metrics()
    _COUNTED.append(m)
    return m


def _tallies() -> list:
    """The process default's tally (no span is open where the smoke
    counts) and the counted Pipelines'."""
    from faucet_tpu_torch import metrics as TM

    return [TM.current().tally] + [m.tally for m in _COUNTED]


def zero_counts():
    """Set the main path's launch counts to 0."""
    for tally in _tallies():
        for k in [k for k in tally if k.endswith("_launches")]:
            del tally[k]


def launch_tally():
    """Every `<kernel>_launches` since zero_counts, summed over
    _tallies(); None on a tree whose kernels count launches in module
    globals (--root of a tree from before kernels/build.py `launch`),
    which reports no launch counts."""
    from faucet_tpu_torch.kernels import build as KB

    if not hasattr(KB, "launch"):
        return None
    out = {}
    for tally in _tallies():
        for k, n in tally.items():
            if k.endswith("_launches"):
                out[k] = out.get(k, 0) + n
    return out


def read_variants() -> dict:
    """The cascade launches by the reference's Pallas variant each stands
    in for: dense (B2), sparse (B3), multi_tile (B4); empty on a tree
    that reports no launch counts (--root)."""
    tally = launch_tally()
    if tally is None:
        return {}
    return {v: tally.get(f"cascade_{v}_launches", 0)
            for v in ("dense", "sparse", "multi_tile")}


def read_counts() -> dict:
    """The main path's launches by kernel; empty on a tree that reports
    no launch counts (--root)."""
    tally = launch_tally()
    if tally is None:
        return {}
    return {k: tally.get(f"{k}_launches", 0) for k in MAIN_KERNELS}


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            log(f"[{name}] start")
            note(f"{name} start")
            rec = report["phases"].setdefault(name, {})
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            dt = time.perf_counter() - t0
            rec["seconds"] = dt
            log(f"[{name}] done in {dt:.2f} s")
            note(f"{name} done in {dt:.2f} s")
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


# cycles of torch.cuda._sleep queued ahead of a device-only timing (about
# 1 ms at the H100's clock), so that the host has queued the timed
# launches before the device reaches the first event
SLEEP_CYCLES = 2_000_000


def cuda_ms(fn, reps: int, setup=None, device_only: bool = False) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events; setup()
    runs before each rep outside the timed region. device_only: the
    device is held busy while the host queues the call, so the time is
    the call's device time alone, not the host's pace."""
    import torch

    times = []
    for _ in range(reps):
        args = setup() if setup else ()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def launch_loop_ms(launch, reps: int = 50) -> float:
    """Device milliseconds per launch of a raw kernel launcher: reps
    back-to-back launches between two CUDA events, queued behind a sleep
    on the device, so the device, not the host's ctypes launches, sets
    the pace."""
    import torch

    launch()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_share(fn):
    """Run fn under torch.profiler. Returns (wall s, summed kernel time s,
    top kernels [(us, name, count)], device launches); one stream, so
    kernels never overlap and their sum is the device's busy time."""
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
    return (wall, sum(r[0] for r in rows) / 1e6, rows[:8],
            sum(r[2] for r in rows))


def log_share(tag, wall, dev, top, n_launches):
    rec = {"wall_s": wall, "device_s": dev,
           "busy_share": dev / wall if wall else None,
           "device_launches": n_launches,
           "top_kernels": [list(r) for r in top]}
    if dev:
        log(f"{tag} under the profiler: wall {wall:.4f} s, kernels "
            f"{dev:.4f} s (host and idle {wall - dev:.4f} s), device busy "
            f"{dev / wall:.3f}, {n_launches} device launches")
        for us, name, cnt in top:
            log(f"    {us / 1e3:9.2f} ms  x{cnt:<6} {name}")
    else:
        log(f"{tag}: the profiler reported no device time (not measured)")
    return rec


def scale_config(genome_len: int, n_reads: int, paired_ends: bool = False,
                 k: int = 31, read_len: int = 100):
    """bench/scale_run.py's configuration (k=31, 100 bp, 8192/batch); the
    wide phase sizes k = 55 and 150 bp reads the same way."""
    from faucet_tpu_torch import Config

    n_kmers = genome_len - k + 1
    return Config(size_kmer=k, max_read_length=read_len, batch_reads=8192,
                  estimated_kmers=n_kmers,
                  singletons=int(n_reads * read_len * 0.005 * k) + n_kmers,
                  junction_capacity=1 << 20, sink_capacity=4 * n_kmers,
                  fp_rate=0.01, paired_ends=paired_ends)


def scale_reads(paired: bool = False):
    """bench/scale_run.py's reads: repeat genome, 30x, 100 bp, 0.5%
    errors, circular, numpy default_rng(0). Paired: the same genome shred
    into mate pairs (insert 300), interleaved."""
    from faucet_tpu_torch import simulate as SIM

    G = int(SCALE_MBP * 1e6)
    rng = np.random.default_rng(0)
    genome = SIM.genome_with_repeats(rng, G, n_repeats=max(4, G // 250_000),
                                     repeat_len=400)
    return genome, shred(SIM, rng, genome, paired)


def shred(SIM, rng, genome, paired: bool, coverage: float = 30.0):
    """100 bp reads at 0.5% errors (coverage per mate when paired);
    paired: interleaved mates."""
    reads = SIM.shred(rng, genome, coverage=coverage, read_len=100,
                      err_rate=0.005, circular=True, paired=paired,
                      insert=300)
    return [x for ab in zip(*reads) for x in ab] if paired else reads


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
    from faucet_tpu_torch.dist.mesh import usable_cpus

    # the CPUs the ranks and the CLI runs share; torch's own default does
    # not see a cgroup quota
    cpus = usable_cpus()
    if torch.get_num_threads() > cpus:
        torch.set_num_threads(cpus)
    info.update(cpu_count=os.cpu_count(), usable_cpus=cpus,
                torch_threads=torch.get_num_threads(),
                loadavg=os.getloadavg())
    report["device"] = info
    log(f"torch {info['torch']} cuda {info['cuda']}; "
        f"{info['count']} device(s); CPUs: {info['cpu_count']} seen, "
        f"{cpus} usable, torch threads {info['torch_threads']}, load "
        f"{info['loadavg']}")
    note(f"{smi}; {cpus} usable CPUs of {info['cpu_count']}")
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


# the least time the card could take (NVIDIA H100 SXM data sheet, at the
# 700 W limit): bytes over the HBM rate, or operations over the peak for
# their type; these kernels do integer work, counted at the non-tensor
# 32-bit rate (67 T/s)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def bound(nbytes: float, nops: float = 0.0) -> dict:
    """{"bound_ms", "bound_by", "bound_bytes", "bound_ops"} of the larger
    of the two lower bounds."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / ALU_OPS_PER_S
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(nops)}


def n_unique(t) -> int:
    import torch

    return int(torch.unique(t).numel())


def _blocks(hi, lo, log2_bits: int):
    """The filter blocks of codes (kernels/probe.py block_address)."""
    from faucet_tpu_torch.core.hashing import hash_pair
    from faucet_tpu_torch.kernels import probe as KP

    return KP.block_address(*hash_pair(hi, lo), log2_bits)[0]


# integer instructions per key of the fused hashing (two fmix32 chains,
# block and rotation) and per probe bit (address, selects, test), from
# csrc/hash.cuh and csrc/bloom_bits.cuh
HASH_OPS, BIT_OPS = 40, 20


def device_launches(fn):
    """(device activities, [(us, name, count)]) of one call of fn: kernels,
    copies and sets, from torch.profiler. Used only after every timed
    phase: the profiler is not started before them."""
    fn()  # warm-up: allocations and the kernel library
    _, _, rows, n = device_share(fn)
    return n, rows


def log_kernel(tag, rec):
    log(f"{tag}: identical; per call: wrapper {rec['ms'] * 1e3:.1f} us, "
        f"kernel alone {rec['device_ms'] * 1e3:.1f} us, plain "
        f"{rec['plain_ms'] * 1e3:.1f} us; bound {rec['bound_ms'] * 1e3:.2f} "
        f"us ({rec['bound_by']}, {rec['bound_bytes']} B), achieved "
        f"{rec['bound_ms'] / rec['device_ms']:.3f} of it alone, "
        f"{rec['bound_ms'] / rec['ms']:.3f} through the wrapper")


@phase("kernels")
def run_kernels():
    import torch

    from faucet_tpu_torch.kernels import build as KB

    lib = KB.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    res = {}
    res.update(check_probe(gen, dev, lib))
    res.update(check_cascade(gen, dev, lib))
    res.update(check_scatter(gen, dev, lib))
    res.update(check_compact(gen, dev, lib))
    res.update(check_wide_ext(gen, dev, lib))
    res.update(check_upsert(dev))
    report["kernels"] = res
    return res


# (shape, mask shape, live share): the walk's frame (4 x 8,192 extensions,
# its [8,192] mask broadcast), the file-mode window probe (8,192 reads x
# 70 windows), the two stacked E-probes, and the k = 55 scan's window
# probe (8,192 reads x 96 windows, its mask the valid windows) and
# extension probe (8,192 x 96 x 8, its mask the unknown lanes, two thirds
# live as in phase 6b)
PROBE_CASES = (((4, 8192), (8192,), 0.9), ((573_440,), (573_440,), 0.9),
               ((1_146_880,), (1_146_880,), 0.9),
               ((8192, 96), (8192, 96), 0.99),
               ((8192, 96, 8), (8192, 96, 8), 0.66))


def check_probe(gen, dev, lib, cases=PROBE_CASES, prefix="probe_"):
    """bloom_contains_codes (B1), hashing fused, against its plain version
    on a half-full 4 MB filter (B, n_hash 3) at each (shape, mask shape,
    live share) of `cases`."""
    import torch

    from faucet_tpu_torch.kernels import build as KB
    from faucet_tpu_torch.kernels import probe as KP

    res, log2_bits, nh = {}, 25, 3
    words = torch.randint(-(1 << 31), 1 << 31, (1 << (log2_bits - 5),),
                          generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    for shape, mshape, density in cases:
        hi, lo = _rand_keys(gen, int(np.prod(shape)), dev)
        hi, lo = hi.view(shape), lo.view(shape)
        mask = torch.rand(mshape, generator=gen, device=dev) < density
        args = (words, hi, lo, mask, nh, log2_bits)
        got = KP.bloom_contains_codes(*args)
        want = KP.bloom_contains_codes_plain(*args)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if err or got.shape != want.shape:
            raise AssertionError(f"bloom_contains_codes != plain at {shape}")
        out = torch.empty_like(got)
        n, live = hi.numel(), mask.expand(shape)
        raw = lambda: KB.check(lib.ft_bloom_contains(
            words.data_ptr(), words.shape[0], hi.data_ptr(), lo.data_ptr(),
            mask.data_ptr(), mask.numel(), out.data_ptr(), n, nh,
            log2_bits - 9, 0, KB.stream_of(words)), "bloom_contains")
        blocks = _blocks(hi[live], lo[live], log2_bits)
        n_live = int(live.sum())
        rec = {"shape": list(shape), "hit_rate": float(want.float().mean()),
               "ms": cuda_ms(lambda: KP.bloom_contains_codes(*args), 20),
               "device_ms": launch_loop_ms(raw),
               "plain_ms": cuda_ms(
                   lambda: KP.bloom_contains_codes_plain(*args), 20),
               "library_ms": None, "max_abs_err": err,
               **bound(mask.numel() + 16 * n_live + n
                       + 64 * n_unique(blocks),
                       n_live * (HASH_OPS + BIT_OPS * nh))}
        log_kernel(f"bloom_contains_codes {list(shape)} (hit rate "
                   f"{rec['hit_rate']:.3f})", rec)
        res[prefix + "x".join(map(str, shape))] = rec
    return res


def check_cascade(gen, dev, lib):
    """cascade_insert (B2-B4), hashing fused, sort-free, against
    cascade_insert_plain: filter words, new_b and solid after each of two
    batches. Shapes: a dense load batch (573,440 keys drawn from a pool of
    300,000, so in-batch repeats, 97% live) and the sparse node-endpoint
    insert (1,146,880 lanes, ~3% live, the same live lanes twice, so the
    second pass promotes them into E); filters of 2**24 / 2**22 bits (2 MB
    / 0.5 MB, the shapes phase 3 used before the redesign) and of the 2
    Mbp run's 2**27 / 2**25 bits (A and D 16 MB, B and E 4 MB); then the
    k = 55 load batch, 786,432 keys dense and sparse, into the wide run's
    2**28 / 2**25 bits."""
    import torch

    run = lambda *a: _cascade_case(dev, lib, *a)
    n = 573_440
    pool_hi, pool_lo = _rand_keys(gen, 300_000, dev)

    def dense_batch():
        pick = torch.randint(0, 300_000, (n,), generator=gen, device=dev)
        return (pool_hi[pick], pool_lo[pick],
                torch.rand((n,), generator=gen, device=dev) < 0.97)

    ns = 1_146_880
    hi, lo = _rand_keys(gen, ns, dev)
    hi = hi | (torch.randint(0, 2, (ns,), generator=gen, device=dev) << 30)
    sparse = [(hi, lo, torch.rand((ns,), generator=gen, device=dev) < 0.03)]
    res = {}
    for la, lb in ((24, 22), (27, 25)):
        for nha in (4, 7):
            res[f"cascade_dense_{la}_{lb}_{nha}_3"] = run(
                f"dense 2**{la}/2**{lb} bits, n_hash {nha}/3", la, lb, nha,
                3, [dense_batch(), dense_batch()])
        res[f"cascade_sparse_{la}_{lb}_3_3"] = run(
            f"sparse 2**{la}/2**{lb} bits, n_hash 3/3", la, lb, 3, 3,
            sparse * 2)
    # the k = 55 load batch (8,192 reads x 96 windows) into phase 6b's
    # filters, A 2**28 and B 2**25 bits, n_hash 5/3: keys from a pool of
    # the 2 Mbp genome's ~2 M k-mers, 97% live; and the same lanes 3% live
    nw = 786_432
    res["cascade_wide_dense_28_25_5_3"] = run(
        "k = 55 dense 2**28/2**25 bits, n_hash 5/3", 28, 25, 5, 3,
        _pool_batches(gen, dev, nw, 0.97))
    hi, lo = _rand_keys(gen, nw, dev)
    res["cascade_wide_sparse_28_25_5_3"] = run(
        "k = 55 sparse 2**28/2**25 bits, n_hash 5/3", 28, 25, 5, 3,
        [(hi, lo, torch.rand((nw,), generator=gen, device=dev) < 0.03)] * 2)
    return res


def _pool_batches(gen, dev, n, live_share, pool=2_000_000):
    """Two load batches of n keys drawn from a pool of a 2 Mbp genome's
    ~2 M k-mers, each lane live at live_share."""
    import torch

    hi, lo = _rand_keys(gen, pool, dev)
    out = []
    for _ in range(2):
        pick = torch.randint(0, pool, (n,), generator=gen, device=dev)
        out.append((hi[pick], lo[pick],
                    torch.rand((n,), generator=gen, device=dev) < live_share))
    return out


def _cascade_case(dev, lib, tag, la, lb, nha, nhb, batches):
    """cascade_insert against cascade_insert_plain over `batches` into
    filters of 2**la / 2**lb bits, from empty: a record per batch."""
    import torch

    from faucet_tpu_torch.kernels import cascade as KC

    a = torch.zeros((1 << (la - 5),), dtype=torch.int32, device=dev)
    b = torch.zeros((1 << (lb - 5),), dtype=torch.int32, device=dev)
    ap, bp = a.clone(), b.clone()
    recs = []
    for bi, (hi, lo, live) in enumerate(batches):
        args = (hi, lo, live, la, lb, 0, nha, nhb)
        n = hi.shape[0]
        rec = {"n": n, "live": int(live.sum()), "library_ms": None}
        # time on copies of the pre-batch state, then apply for real
        rec["ms"] = cuda_ms(KC.cascade_insert, 10,
                            setup=lambda: (a.clone(), b.clone()) + args)
        rec["plain_ms"] = cuda_ms(
            KC.cascade_insert_plain, 5,
            setup=lambda: (ap.clone(), bp.clone()) + args)
        rec["device_ms"] = _cascade_insert_ms(dev, lib, a.clone(),
                                              b.clone(), args)
        a0, b0 = a.clone(), b.clone()
        nb, sol = KC.cascade_insert(a, b, *args)
        nbp, solp = KC.cascade_insert_plain(ap, bp, *args)
        torch.cuda.synchronize()
        err = max(int((a.long() - ap.long()).abs().max()),
                  int((b.long() - bp.long()).abs().max()),
                  int((nb.int() - nbp.int()).abs().max()),
                  int((sol.int() - solp.int()).abs().max()))
        if err:
            raise AssertionError(f"cascade_insert != plain ({tag}, "
                                 f"batch {bi})")
        rec["max_abs_err"] = err
        # bytes this batch needs: codes of live lanes, mask, flags, each
        # touched block of A and B read once, each changed block
        # written once
        keep = live & (hi != KC.SENTINEL)
        ba = _blocks(hi[keep], lo[keep], la)
        bb = _blocks(hi[keep], lo[keep], lb)
        changed = lambda x, y: int((x != y).view(-1, 16).any(1).sum())
        n_live = rec["live"]
        rec.update(bound(
            3 * n + 16 * n_live + 64 * (n_unique(ba) + n_unique(bb)
                                        + changed(a, a0)
                                        + changed(b, b0)),
            n_live * (HASH_OPS + BIT_OPS * (nha + nhb))))
        log_kernel(f"cascade_insert {tag} batch {bi} (new_b "
                   f"{int(nb.sum())}, solid {int(sol.sum())})", rec)
        recs.append(rec)
    return recs


def _cascade_insert_ms(dev, lib, a, b, args):
    """cascade_insert's three launches alone, back to back on one batch
    and one state (the first pass fills A, later ones B: each pass ORs one
    block per key)."""
    import torch

    from faucet_tpu_torch.kernels import build as KB
    from faucet_tpu_torch.kernels import cascade as KC

    hi, lo, live, la, lb, sb, nha, nhb = args
    n = hi.shape[0]
    n_slots = KC.n_slots_for(n)
    table = KC._table(dev, n_slots)
    lanes = torch.empty((n,), dtype=torch.int32, device=dev)
    nb, sol = (torch.empty((n,), dtype=torch.bool, device=dev)
               for _ in range(2))
    return launch_loop_ms(lambda: KB.check(lib.ft_cascade_insert(
        a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0],
        hi.data_ptr(), lo.data_ptr(), live.data_ptr(), n, la - 9, lb - 9,
        0, nha, nhb, table.data_ptr(), n_slots, lanes.data_ptr(),
        nb.data_ptr(), sol.data_ptr(), KB.stream_of(a)), "cascade"),
        reps=20)


def _bits_set(gen, n_words, dev):
    """A filter with about an eighth of its bits set (OR must keep them)."""
    import torch

    w = torch.randint(-(1 << 31), 1 << 31, (n_words,), generator=gen,
                      device=dev, dtype=torch.int64).to(torch.int32)
    return w & 0x01010101


def check_scatter(gen, dev, lib):
    """bloom_insert_codes (B5), hashing fused, at the file-mode batch,
    573,440 codes (90% live), into A (16 MB, n_hash 4) and B (4 MB, n_hash
    3) with an eighth of their bits set; then scatter_or_bits (B6), 4
    positions per key into 16 MB. Both equal their plain versions bit for
    bit. Each timed run starts from a fresh copy of the filter."""
    import torch

    from faucet_tpu_torch.kernels import bloom_scatter as KS
    from faucet_tpu_torch.kernels import build as KB

    res, n = {}, 573_440
    hi, lo = _rand_keys(gen, n, dev)
    live = torch.rand((n,), generator=gen, device=dev) < 0.9
    n_live = int(live.sum())

    def compare(tag, kernel, plain, w0, args, raw, cost):
        """cost(result) -> (bytes, operations) this input needs: each
        input read once, each changed word or block written once."""
        got, want = kernel(w0.clone(), *args), plain(w0.clone(), *args)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err or torch.equal(got, w0):
            raise AssertionError(f"{tag}: kernel != plain (or no bit set)")
        fresh = lambda: (w0.clone(),)
        rec = {"ms": cuda_ms(kernel, 20, setup=lambda: (w0.clone(), *args)),
               "device_ms": cuda_ms(lambda w: KB.check(raw(w), tag), 20,
                                    setup=fresh, device_only=True),
               "plain_ms": cuda_ms(plain, 10,
                                   setup=lambda: (w0.clone(), *args)),
               "library_ms": None, "max_abs_err": err, **bound(*cost(got))}
        log_kernel(tag, rec)
        return rec

    for name, log2_bits, nh in (("A", 27, 4), ("B", 25, 3)):
        w0 = _bits_set(gen, 1 << (log2_bits - 5), dev)
        args = (hi, lo, live, nh, log2_bits)
        raw = lambda w: lib.ft_bloom_insert_codes(
            w.data_ptr(), w.shape[0], hi.data_ptr(), lo.data_ptr(),
            live.data_ptr(), n, nh, log2_bits - 9, 0, KB.stream_of(w))
        blocks = _blocks(hi[live], lo[live], log2_bits)
        res[f"insert_codes_{name}"] = compare(
            f"bloom_insert_codes {name} n_hash {nh}", KS.bloom_insert_codes,
            KS.bloom_insert_codes_plain, w0, args, raw,
            lambda got: (n + 16 * n_live + 64 * (
                n_unique(blocks) + int(
                    (got != w0).view(-1, 16).any(1).sum())),
                n_live * (HASH_OPS + BIT_OPS * nh)))
    w0 = _bits_set(gen, 1 << 22, dev)
    pos = torch.randint(0, 1 << 27, (4 * n,), generator=gen, device=dev)
    pos = torch.where(torch.rand((4 * n,), generator=gen, device=dev) < 0.9,
                      pos, KS.SENTINEL)
    res["scatter_bits"] = compare(
        "scatter_or_bits 16 MB", KS.scatter_or_bits, KS.scatter_or_bits_plain,
        w0, (pos,), lambda w: lib.ft_scatter_or_bits(
            w.data_ptr(), w.shape[0], pos.data_ptr(), 4 * n,
            KB.stream_of(w)),
        lambda got: (8 * 4 * n + 4 * (
            n_unique(pos[pos != KS.SENTINEL] >> 5)
            + int((got != w0).sum())), 0))
    # unaligned views, short inputs, positions past the filter's end
    far = torch.randint(0, 1 << 28, (4097,), generator=gen, device=dev)
    cases = [(pos, 1, 4 * n - 1), (pos, 0, 1), (pos, 1, 1), (pos, 1, 2),
             (pos, 0, 3), (pos, 3, 1000), (far, 0, 4097), (far, 1, 4096)]
    for src, off, m in cases:
        p = src[off:off + m]
        got = KS.scatter_or_bits(w0.clone(), p)
        want = KS.scatter_or_bits_plain(w0.clone(), p)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"scatter_or_bits: offset {off}, {m} "
                                 "positions: != plain")
    log(f"scatter_or_bits: identical on {len(cases)} unaligned, short and "
        "past-the-end inputs")
    return res


# (N, live share, cap): cap 8,192 on the scan grid of one file-mode batch
# (573,440 lanes) at ~1.5% and ~30% live (both counts above cap) and on a
# spool flush (1,048,576 lanes, ~0.5% live, count below cap); the callers'
# shape, cap = N = 573,440 (upsert_rounds and the spool append take every
# live lane in one call), at ~1.5% and ~30% live; and the k = 55 scan
# grid, cap = N = 786,432, at the junction (2.7%) and sink (2.4%) shares
# phase 6b measures
COMPACT_CASES = ((573_440, 0.015, 8192), (573_440, 0.3, 8192),
                 (1_048_576, 0.005, 8192), (573_440, 0.015, 573_440),
                 (573_440, 0.3, 573_440), (786_432, 0.027, 786_432),
                 (786_432, 0.024, 786_432))


def check_compact(gen, dev, lib, cases=COMPACT_CASES, prefix="compact_",
                  epoch_run: bool = True):
    """mask_indices (B7) against its plain version at each (N, live share,
    cap) of `cases`; beside it, as a yardstick only (the port never calls
    it), torch.nonzero_static(mask, size=cap) plus the count. Then
    (epoch_run) 1,000 back-to-back calls of changing size and alignment
    with the epoch limit lowered so that it wraps, every 100th call held
    to the plain version."""
    import torch

    from faucet_tpu_torch.kernels import compact as KCP

    res = {}
    for n, density, cap in cases:
        mask = torch.rand((n,), generator=gen, device=dev) < density
        idx, cnt = KCP.mask_indices(mask, cap)
        pidx, pcnt = KCP.mask_indices_plain(mask, cap)
        torch.cuda.synchronize()
        m = min(int(pcnt), cap)
        err = max(abs(int(cnt) - int(pcnt)),
                  int((idx[:m] - pidx[:m]).abs().max()) if m else 0)
        if err or int(pcnt) != int(mask.sum()):
            raise AssertionError(f"mask_indices N={n} d={density} cap={cap}"
                                 ": kernel != plain")
        out = torch.empty((cap + 1,), dtype=torch.int64, device=dev)
        rec = {"count": int(pcnt), "cap": cap,
               "ms": cuda_ms(lambda: KCP.mask_indices(mask, cap), 20),
               "device_ms": launch_loop_ms(
                   lambda: KCP.launch(mask, out[:cap], out[cap])),
               "plain_ms": cuda_ms(lambda: KCP.mask_indices_plain(mask, cap),
                                   20),
               "max_abs_err": err, **bound(n + 8 * m + 8)}
        try:
            lib_idx = torch.nonzero_static(mask, size=cap).view(-1)
            if not torch.equal(lib_idx[:m], pidx[:m]):
                raise AssertionError("nonzero_static disagrees")
            rec["library_ms"] = cuda_ms(
                lambda: (torch.nonzero_static(mask, size=cap), mask.sum()),
                20)
        except (RuntimeError, NotImplementedError) as e:
            rec["library_ms"] = None
            rec["library_note"] = f"nonzero_static raises on CUDA: {e}"[:200]
        log_kernel(f"mask_indices N={n} count {int(pcnt)} (cap {cap})", rec)
        log(f"    library yardstick, nonzero_static + count: "
            + (f"{rec['library_ms'] * 1e3:.1f} us" if rec["library_ms"]
               is not None else rec["library_note"]))
        res[f"{prefix}{n}_{density}_{cap}"] = rec
    if not epoch_run:
        return res

    # epoch reuse: sizes and offsets change from call to call, nothing
    # synchronises in between, and the epoch wraps every 300 calls
    rng = np.random.default_rng(17)
    base = torch.rand((1_100_000,), generator=gen, device=dev) < 0.2
    limit, KCP.EPOCH_LIMIT = KCP.EPOCH_LIMIT, 300
    kept = []
    try:
        for i in range(1000):
            off = int(rng.integers(0, 32))
            n = int(rng.choice([0, 1, 4095, 4097, 70_000, 573_440,
                                1_048_576]))
            mask = base[off:off + n]
            got = KCP.mask_indices(mask, n)
            if i % 100 == 99:
                kept.append((mask, got))
    finally:
        KCP.EPOCH_LIMIT = limit
    torch.cuda.synchronize()
    for mask, (idx, cnt) in kept:
        pidx, pcnt = KCP.mask_indices_plain(mask, mask.shape[0])
        if int(cnt) != int(pcnt) or not torch.equal(idx[:int(cnt)],
                                                    pidx[:int(cnt)]):
            raise AssertionError("mask_indices: back-to-back run != plain")
    res["compact_epoch_run"] = {"calls": 1000, "checked": len(kept),
                                "max_abs_err": 0}
    log(f"mask_indices: 1000 back-to-back calls (epoch wrapping every 300),"
        f" {len(kept)} held to the plain version: identical")
    return res


# integer instructions per window of csrc/wide_ext.cu: per slot two
# ft_hash calls and the final pair (6 fmix32), the shifts, the compare and
# the select, ~60
WIDE_EXT_OPS = 8 * 60


def check_wide_ext(gen, dev, lib, k: int = 55, B: int = 8192, L: int = 100):
    """slot_ext_keys (csrc/wide_ext.cu, no Pallas counterpart) against its
    plain version at the k = 55 stream batch's windows: 8,192 reads of
    100 bp made on the card, 1% N, 46 windows a read."""
    import torch

    from faucet_tpu_torch.core import wide as WD
    from faucet_tpu_torch.kernels import build as KB
    from faucet_tpu_torch.kernels import wide_ext as KW

    bases = torch.randint(0, 4, (B, L), generator=gen, device=dev,
                          dtype=torch.uint8)
    bases[torch.rand((B, L), generator=gen, device=dev) < 0.01] = 4
    wv = WD.kmerize_wide(bases, torch.full((B,), L, dtype=torch.int32,
                                           device=dev), k)
    canon, other = wv.canon, WD.wselect(wv.canon_is_fwd, wv.rc, wv.fwd)
    got = KW.slot_ext_keys(canon, other, k)
    want = KW.slot_ext_keys_plain(canon, other, k)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if err:
        raise AssertionError("slot_ext_keys != plain")
    n = canon[0].numel()
    his, los = torch.empty_like(got[0]), torch.empty_like(got[1])
    raw = lambda: KB.check(lib.ft_wide_ext_keys(
        canon.data_ptr(), other.data_ptr(), n, k, his.data_ptr(),
        los.data_ptr(), KB.stream_of(canon)), "wide_ext_keys")
    rec = {"shape": list(canon.shape[1:]), "k": k,
           "ms": cuda_ms(lambda: KW.slot_ext_keys(canon, other, k), 20),
           "device_ms": launch_loop_ms(raw),
           "plain_ms": cuda_ms(
               lambda: KW.slot_ext_keys_plain(canon, other, k), 20),
           "library_ms": None, "max_abs_err": err,
           # each window's 8 input words and 16 output keys, as int64
           **bound(192 * n, WIDE_EXT_OPS * n)}
    log_kernel(f"slot_ext_keys k = {k} {list(canon.shape[1:])}", rec)
    return {f"wide_ext_{B}x{n // B}": rec}


# the k = 55 stream cell's tables (benchmark/sizing.py program_kwargs):
# (name, capacity, value arrays (trailing shape, dtype, mode), keys put in
# before the timed calls, about a dataset's end)
UPSERT_CASES = (
    ("sink", 1 << 24, (((), "int32", "add"), ((4,), "int64", "max")),
     2_000_000),
    ("junction", 1 << 20, (((8,), "int32", "add"), ((8,), "int32", "max"),
                           ((4,), "int64", "max")), 150_000),
)


def check_upsert(dev, live: int = 12_000, reps: int = 20):
    """A k = 55 stream batch's table updates (kernels/upsert.py
    upsert_lanes, csrc/table_upsert.cu, no Pallas counterpart) against its
    plain version (per K-lane chunk: the gathers, the junction rows,
    dedupe and the torch rounds) on the same CUDA inputs: a scan grid of
    8,192 x 46 windows with `live` update lanes (two K = 8,192 chunks),
    listed by the compaction, half their keys held by the table, a tenth
    of them repeated, into the cell's tables filled to about a dataset's
    end. Bit-identical rows [:cap], count and dropped; the wrapper, the
    kernel alone and the plain version timed on fresh grids; the bound
    from the bytes the rounds need at the rounds the plain version ran.
    Wrapper and kernel alone are one call: the kernel alone is the
    wrapper timed behind a device sleep, which hides its host part."""
    import torch

    KU = _kernel_module("upsert")
    if KU is None or not hasattr(KU, "upsert_lanes"):
        log("kernels/upsert.py upsert_lanes: not in this tree")
        return {}
    from faucet_tpu_torch import metrics as TM
    from faucet_tpu_torch.core import scan as SC
    from faucet_tpu_torch.core import table as TT
    from faucet_tpu_torch.kernels import compact as KCP

    g = torch.Generator(device=dev)
    g.manual_seed(15)
    N, K = 8192 * 46, 8192
    ints = lambda hi, *shape: torch.randint(0, hi, shape or (N,),
                                            generator=g, device=dev)
    res = {}
    for name, cap, specs, fill in UPSERT_CASES:
        specs = [(s, getattr(torch, d), m) for s, d, m in specs]
        modes = tuple(m for _, _, m in specs)
        junction = name == "junction"
        pool = 4 * fill
        phi, plo = ints(1 << 30, pool), ints(1 << 32, pool)
        tbl = TT.make(cap, tuple((sh, dt) for sh, dt, _ in specs),
                      device=dev)
        for lo_key in range(0, fill, 1 << 16):
            m = min(1 << 16, fill - lo_key)
            pick = torch.arange(lo_key, lo_key + m, device=dev)
            vals = tuple(torch.randint(0, 1 << 20, (m,) + sh, generator=g,
                                       device=dev, dtype=dt)
                         for sh, dt, _ in specs)
            tbl = KU.probe_rounds(tbl, phi[pick], plo[pick], vals,
                                  torch.ones(m, dtype=torch.bool,
                                             device=dev), modes)

        def fresh():
            """A grid: keys half held, half new, a tenth repeated."""
            mask = torch.zeros(N, dtype=torch.bool, device=dev)
            mask[torch.randperm(N, generator=g, device=dev)[:live]] = True
            pick = ints(fill, N) + fill // 2
            rep = torch.rand(N, generator=g, device=dev) < 0.1
            pick = torch.where(rep, pick % 512 + fill // 2, pick)
            words = ints(1 << 32, 4, N).t()
            if junction:
                slots = (ints(8), ints(8), ints(46), ints(46),
                         torch.rand(N, generator=g, device=dev) < 0.6,
                         torch.rand(N, generator=g, device=dev) < 0.6)
                vals = (words,)
            else:
                slots = None
                vals = (ints(3).to(torch.int32) + 1, words)
            idx, cnt = KCP.mask_indices(mask, N)
            return (idx, cnt, K, phi[pick], plo[pick], vals, modes, slots,
                    SC.cov_dist8)

        clone = lambda t: t._replace(
            keys_hi=t.keys_hi.clone(), keys_lo=t.keys_lo.clone(),
            vals=tuple(v.clone() for v in t.vals))
        args = fresh()
        chunks = []
        orig = KU.rounds

        def rounds(step, p, max_rounds):
            chunks.append([])

            def counted(r, p):
                chunks[-1].append(int(p.sum()))
                return step(r, p)
            return orig(counted, p, max_rounds)

        KU.rounds = rounds
        m = TM.Metrics()
        try:
            with m.span("plain"):
                want = KU.upsert_lanes_plain(clone(tbl), *args)
        finally:
            KU.rounds = orig
        mk = TM.Metrics()
        with mk.span("kernel"):
            got = KU.upsert_lanes(clone(tbl), *args)
        torch.cuda.synchronize()
        launches = mk.tally.get("upsert_launches", 0)
        err = 0
        for x, y in zip((got.keys_hi, got.keys_lo) + got.vals,
                        (want.keys_hi, want.keys_lo) + want.vals):
            err = max(err, int((x[:cap].to(torch.int64)
                                - y[:cap].to(torch.int64)).abs().max()))
        err = max(err, abs(int(got.count) - int(want.count)),
                  abs(int(got.dropped) - int(want.dropped)))
        if err or launches != 1:
            raise AssertionError(f"upsert {name}: kernel != plain ({err}) "
                                 f"or {launches} launches")
        won = int(want.count) - int(tbl.count)
        keys = sum(c[0] for c in chunks)  # distinct keys of each chunk
        pending = [x for c in chunks for x in c]
        row = sum(int(torch.tensor([], dtype=dt).element_size())
                  * max(1, int(np.prod(sh))) for sh, dt, _ in specs)
        # a lane's list entry, key words and fields (the junction's four
        # int64 slot fields and two flags in place of its two rows);
        # each round's pending keys' key words, the winners' claim (store,
        # max, read) and key writes, and each written row read and
        # written once
        lane = 8 + 16 + row - (64 - 34 if junction else 0)
        nbytes = (live * lane + 8 * sum(pending) + won * (24 + 8)
                  + 2 * row * (keys - int(want.dropped)))
        wrapped = lambda a: KU.upsert_lanes(tbl, *a)
        plain = lambda a: KU.upsert_lanes_plain(tbl, *a)
        setup = lambda: (fresh(),)
        rec = {"lanes": N, "live": live, "chunks": len(chunks),
               "capacity": cap, "held": int(tbl.count), "won": won,
               "keys": keys, "rounds": sum(1 for x in pending if x),
               "pending_by_round": chunks,
               "plain_host_syncs": m.tally.get("host_syncs", 0),
               "launches_per_call": launches,
               "ms": cuda_ms(wrapped, reps, setup=setup),
               # the wrapper launches nothing else: behind the sleep its
               # host part is hidden, and the events time the kernel
               "device_ms": cuda_ms(wrapped, reps, setup=setup,
                                    device_only=True),
               "plain_ms": cuda_ms(plain, reps, setup=setup),
               "library_ms": None, "max_abs_err": err, **bound(nbytes)}
        log_kernel(f"upsert_lanes {name} cap 2**{cap.bit_length() - 1} "
                   f"{live} of {N} lanes ({len(chunks)} chunks, "
                   f"{rec['rounds']} rounds)", rec)
        res[f"upsert_{name}_{live}"] = rec
    return res


@phase("entries")
def run_entries():
    """The scatter-OR kernels' entry points, which no path calls:
    core/bloom.bloom_insert (B5) into A (16 MB, n_hash 4) and B (4 MB,
    n_hash 3), timed per call (CUDA events; on an earlier tree the same
    call hashed in torch and then launched B5), then driven once each and
    counted, CUDA == CPU; scatter_or_bits (B6) likewise."""
    import torch

    from faucet_tpu_torch.core import bloom as BL
    from faucet_tpu_torch.kernels import bloom_scatter as KS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    n = 573_440
    hi, lo = _rand_keys(gen, n, dev)
    live = torch.rand((n,), generator=gen, device=dev) < 0.9
    w0 = _bits_set(gen, 1 << 22, dev)
    pos = torch.randint(0, 1 << 27, (4 * n,), generator=gen, device=dev)
    rec = {}
    for log2_bits, nh in ((27, 4), (25, 3)):
        rec[f"bloom_insert_{log2_bits}_{nh}_ms"] = ms = cuda_ms(
            lambda b: BL.bloom_insert(b, hi, lo, live, nh, log2_bits), 20,
            setup=lambda: (BL.make_bloom(log2_bits, dev),))
        log(f"bloom_insert 2**{log2_bits} bits, n_hash {nh}: {ms * 1e3:.1f} "
            "us per call")
    zero_counts()
    for log2_bits, nh in ((27, 4), (25, 3)):
        bg = BL.make_bloom(log2_bits, dev)
        bc = BL.make_bloom(log2_bits)
        BL.bloom_insert(bg, hi, lo, live, nh, log2_bits)
        BL.bloom_insert(bc, hi.cpu(), lo.cpu(), live.cpu(), nh, log2_bits)
        if not torch.equal(bg.words.cpu(), bc.words):
            raise AssertionError("bloom_insert: CUDA != CPU")
    bits = KS.scatter_or_bits(w0.clone(), pos)
    if not torch.equal(bits.cpu(), KS.scatter_or_bits(w0.cpu(), pos.cpu())):
        raise AssertionError("scatter_or_bits: CUDA != CPU")
    tally = launch_tally()
    report["entry_launches"] = {} if tally is None else {
        k: tally.get(f"{k}_launches", 0)
        for k in ("bloom_insert_codes", "scatter_or_bits")}
    report["phases"]["entries"].update(rec)
    log(f"bloom_insert (A, B) and scatter_or_bits on CUDA == on the CPU; "
        f"launches {report['entry_launches']}")


def _table_arrays(t):
    from faucet_tpu_torch.ckpt import state as CK

    d = CK.table_to_numpy(t)
    return [d["keys_hi"], d["keys_lo"], *d["vals"], d["count"],
            d["dropped"]]


@functools.lru_cache(None)
def parity_case():
    """The ~50 kbp repeat genome (two 200 bp repeats) as 40x of 100 bp
    reads at 0.5% errors, numpy default_rng(777)."""
    from faucet_tpu_torch import simulate as SIM

    rng = np.random.default_rng(777)
    genome = SIM.genome_with_repeats(rng, 50_000, n_repeats=2,
                                     repeat_len=200)
    return genome, SIM.shred(rng, genome, coverage=40, read_len=100,
                             err_rate=0.005, circular=True)


# phase 4's cases: (name, k, Config options)
PARITY_CASES = (("k21", 21, {}), ("k55", 55, {}),
                ("exact_k21", 21, {"exact": True}),
                ("exact_k55", 55, {"exact": True}),
                ("prune_k21", 21, {"prune_slot_cov": 2}))


def _parity_cfg(k, kw):
    from faucet_tpu_torch import Config

    return Config(size_kmer=k, max_read_length=100, batch_reads=2048,
                  estimated_kmers=1 << 16, singletons=1 << 17,
                  junction_capacity=1 << 14, sink_capacity=1 << 17,
                  fp_rate=0.002, **kw)


def _parity_run(name, k, kw, dev):
    """One parity case on one device: (sorted canonical contigs, tables
    as numpy, walk timer record, seconds). The counts are set to 0 just
    before the exact k = 21 run on CUDA and read just after it (the
    "exact" path)."""
    from faucet_tpu_torch.graph import walk as W
    from faucet_tpu_torch.pipeline import Pipeline

    reads = parity_case()[1]
    cfg = _parity_cfg(k, kw)
    t0 = time.perf_counter()
    p = Pipeline(cfg, counted_metrics(), device=dev)
    walk = "walk_round_wide" if cfg.wide else "walk_round"
    orig, wrapped, wst = _walk_timer(name=walk)
    if dev == "cuda":
        setattr(W, walk, wrapped)
        if name == "exact_k21":
            zero_counts()
    try:
        g = p.run_file_mode(reads, reads)
    finally:
        setattr(W, walk, orig)
    if dev == "cuda" and name == "exact_k21":
        report["launches_by_path"]["exact"] = read_counts()
    tables = [p.junctions, p.sinks]
    if cfg.exact:
        tables += [p.cascade.a_table, p.cascade.b_table]
        if p.node_cascade is not None:
            tables += [p.node_cascade.a_table, p.node_cascade.b_table]
    return (sorted(g.contigs[i].canonical_seq() for i in g.live()),
            [_table_arrays(t) for t in tables], dict(wst),
            time.perf_counter() - t0)


def _parity_cpu_runs(root):
    """Every parity case on the CPU, in a process of its own (run beside
    the CUDA runs)."""
    if root not in sys.path:
        sys.path.insert(0, root)
    return {name: _parity_run(name, k, kw, "cpu")
            for name, k, kw in PARITY_CASES}


@phase("parity")
def run_parity():
    """The ~50 kbp repeat genome at k = 21 (branch-node junctions) and at
    k = 55 (wide codes, ext8 junctions), in Bloom mode, in exact mode and
    (k = 21) with the prune_slots pre-clean: CPU (plain versions) == CUDA
    (kernels), contigs and tables, code-word columns included, and in
    exact mode the cascade and node-cascade tables. The CPU runs go in a
    process of their own beside the CUDA runs; each CUDA run's walk is
    timed."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    genome = parity_case()[0]
    rec = report["phases"]["parity"]
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as ex:
        cpu = ex.submit(_parity_cpu_runs, ROOT)
        cuda = {name: _parity_run(name, k, kw, "cuda")
                for name, k, kw in PARITY_CASES}
        cpu = cpu.result(timeout=600)
    for name, k, kw in PARITY_CASES:
        out = {"cpu": cpu[name], "cuda": cuda[name]}
        for dev in ("cpu", "cuda"):
            log(f"{name} {dev}: {len(out[dev][0])} contigs in "
                f"{out[dev][3]:.2f} s")
        (ca, ta, _, _), (cb, tb, wst, _) = out["cpu"], out["cuda"]
        if ca != cb:
            raise AssertionError(f"{name}: CPU and CUDA contig sets differ")
        if [len(x) for x in ta] != [len(x) for x in tb]:
            raise AssertionError(f"{name}: table columns differ")
        for x, y in zip(sum(ta, []), sum(tb, [])):
            if not np.array_equal(x, y):
                raise AssertionError(f"{name}: CPU and CUDA tables differ")
        frac = genome_true_frac(cb, genome)
        ms_step = 1e3 * wst["seconds"] / max(wst["steps"], 1)
        log(f"{name}: identical assemblies and {len(ta)} tables: "
            f"{len(cb)} contigs, {len(ta[0]) - 4} junction value columns, "
            f"genome-true {frac:.5f}; CUDA walk {wst['steps']} steps, "
            f"{ms_step:.3f} ms/step")
        rec[name] = dict(contigs=len(cb), genome_true=frac, walk=wst,
                         walk_ms_per_step=ms_step)
        if frac < 0.99:
            raise AssertionError(f"{name}: genome-true {frac:.5f} < 0.99")
    for k in (21, 55):
        log(f"walk ms/step at k = {k} on CUDA: Bloom "
            f"{rec[f'k{k}']['walk_ms_per_step']:.3f}, exact "
            f"{rec[f'exact_k{k}']['walk_ms_per_step']:.3f}")


def _walk_timer(profile_round=None, name: str = "walk_round",
                module=None):
    """Wrap graph.walk's round function `name` (walk_round, or
    walk_round_wide for k > 31; or `module`'s, e.g. dist.swalk's
    walk_round_routed) to count rounds/steps and time them (one
    synchronize per round of 64-256 steps). Round `profile_round` runs
    under the profiler instead and is left out of the counts."""
    import torch

    from faucet_tpu_torch.graph import walk as W

    st = {"rounds": 0, "steps": 0, "lane_steps": 0, "seconds": 0.0}
    orig = getattr(module or W, name)

    def timed(cascade, junctions, fr, n_steps, cfg, **kw):
        st["rounds"] += 1
        if st["rounds"] == profile_round:
            out = []
            rec = st["profiled_round"] = log_share(
                f"walk round {profile_round} ({n_steps} steps x "
                f"{fr.steps.shape[0]} lanes)", *device_share(
                    lambda: out.append(orig(cascade, junctions, fr, n_steps,
                                            cfg, **kw))))
            rec["launches_per_step"] = rec["device_launches"] / n_steps
            log(f"    {rec['launches_per_step']:.2f} device launches per "
                "walk step")
            return out[0]
        t0 = time.perf_counter()
        r = orig(cascade, junctions, fr, n_steps, cfg, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st["seconds"] += dt
        st["steps"] += n_steps
        st["lane_steps"] += n_steps * fr.steps.shape[0]
        # steps and seconds by frontier width
        w = st.setdefault("by_lanes", {}).setdefault(fr.steps.shape[0],
                                                     [0, 0.0])
        w[0] += n_steps
        w[1] += dt
        return r

    return orig, timed, st


@phase("scale")
def run_scale(profile: bool = False):
    import torch

    from faucet_tpu_torch.graph import walk as W
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    t0 = time.perf_counter()
    genome, reads = scale_reads()
    log(f"{SCALE_MBP} Mbp genome, {len(reads)} reads synthesized in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = scale_config(len(genome), len(reads))
    p = Pipeline(cfg, counted_metrics(), device="cuda")
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
    if profile:
        _profile_load_batch(p, 10)
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
    # the dualk phase's first pass
    return genome, reads, cfg, g


def _profile_load_batch(p, k: int):
    """Run the k-th load batch of Pipeline p under the profiler: its split
    into device (kernel) time and host time."""
    load_batch, calls = p.load_batch, [0]

    def wrapped(bases, lens):
        calls[0] += 1
        if calls[0] != k:
            return load_batch(bases, lens)
        report["phases"]["scale"]["profiled_load_batch"] = log_share(
            f"load batch {k}", *device_share(
                lambda: load_batch(bases, lens)))

    p.load_batch = wrapped


def phased_case():
    """tests/golden/test_pairs.py's phased repeat: r is planted twice
    between four distinct junction families; mate pairs spanning each
    copy phase it. Returns (interleaved reads, true splices, wrong ones)."""
    from faucet_tpu_torch import simulate as SIM

    rng = np.random.default_rng(4242)
    g = lambda n: SIM.random_genome(rng, n)
    p, q, s, t, r = g(40), g(40), g(40), g(40), g(40)
    A, B, C, D = g(60), g(60), g(60), g(60)
    M = [g(220) for _ in range(6)]
    genome = (p + A + r + B + q + M[0] + s + C + r + D + t + M[1]
              + p + M[2] + q + M[3] + s + M[4] + t + M[5])
    m1, m2 = SIM.shred(rng, genome, coverage=60, read_len=80,
                       circular=True, paired=True, insert=250)
    return ([x for ab in zip(m1, m2) for x in ab], (A + r + B, C + r + D),
            (A + r + D, C + r + B))


def phasing(g, truths, wrongs, k: int):
    """(true splices, wrong splices) present in the graph's contigs."""
    from faucet_tpu_torch.core.kmer import revcomp_seq

    seqs = []
    for i in g.live():
        c = g.contigs[i]
        s = c.seq + (c.seq[: k - 1] if c.circular else "")
        seqs += [s, revcomp_seq(s)]
    joined = "#".join(seqs)
    return (sum(x in joined for x in truths),
            sum(x in joined for x in wrongs))


@phase("paired")
def run_paired():
    """(a) The phased repeat in Bloom mode, on the CPU and on CUDA:
    identical contigs, junction, sink and pair tables, and both phase it.
    (b) 2 Mbp paired (the scale genome shred into mate pairs), two-pass
    file mode: the reference's record PAIRED_RECORD, >= 99% genome-true."""
    import torch

    from faucet_tpu_torch import Config
    from faucet_tpu_torch.graph import walk as W
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    reads, truths, wrongs = phased_case()
    cfg = Config(size_kmer=21, max_read_length=80, batch_reads=128,
                 estimated_kmers=1 << 15, singletons=1 << 15,
                 junction_capacity=1 << 13, sink_capacity=1 << 14,
                 pair_capacity=1 << 14, paired_ends=True)
    out = {}
    for dev in ("cpu", "cuda"):
        p = Pipeline(cfg, counted_metrics(), device=dev)
        p.load_reads(reads)
        p.scan_paired(reads)
        g = p.clean_graph(p.build())
        ph = phasing(g, truths, wrongs, 21)
        dis = p.metrics.counters.get("clean_disentangled", 0)
        log(f"phased repeat on {dev}: {len(g.live())} contigs, "
            f"{int(p.pairs.count)} pair keys, disentangled {dis}, "
            f"splices true/wrong {ph}")
        if ph != (2, 0) or dis < 1:
            raise AssertionError(f"{dev}: the repeat is not phased")
        out[dev] = (sorted((g.contigs[i].canonical_seq(), g.contigs[i].cov)
                           for i in g.live()),
                    [a for t in (p.junctions, p.sinks, p.pairs)
                     for a in _table_arrays(t)], p.pair_counts())
    (ca, ta, pa), (cb, tb, pb) = out["cpu"], out["cuda"]
    if ca != cb or pa != pb or not all(
            np.array_equal(x, y) for x, y in zip(ta, tb)):
        raise AssertionError("phased repeat: CPU and CUDA differ")
    log("phased repeat: CPU and CUDA identical")

    t0 = time.perf_counter()
    genome, reads = scale_reads(paired=True)
    log(f"{SCALE_MBP} Mbp genome, {len(reads)} interleaved mates "
        f"synthesized in {time.perf_counter() - t0:.2f} s")
    cfg = scale_config(len(genome), len(reads), paired_ends=True)
    p = Pipeline(cfg, counted_metrics(), device="cuda")
    ph = {}
    orig, wrapped, wst = _walk_timer()
    W.walk_round = wrapped
    try:
        for name, fn in (
                ("load", lambda: p.load_batches(batch_iter(reads, cfg))),
                ("scan_paired",
                 lambda: p.scan_paired_batches(batch_iter(reads, cfg))),
                ("graph_build", p.build)):
            t = time.perf_counter()
            g = fn()
            torch.cuda.synchronize()
            ph[name] = time.perf_counter() - t
            log(f"  {name}: {ph[name]:.2f} s")
    finally:
        W.walk_round = orig
    log(f"  walk: {wst['rounds']} rounds, {wst['steps']} steps timed in "
        f"{wst['seconds']:.2f} s, "
        f"{1e3 * wst['seconds'] / max(wst['steps'], 1):.3f} ms/step")
    t = time.perf_counter()
    g = p.clean_graph(g)
    ph["clean"] = time.perf_counter() - t
    contigs = [g.contigs[i].seq for i in g.live()]
    lens = [len(c) for c in contigs]
    got = {"contigs": len(contigs), "n50": n50(lens), "total": sum(lens),
           "disentangled": p.metrics.counters.get("clean_disentangled", 0),
           "pair_keys": int(p.pairs.count),
           "junctions": int(p.junctions.count), "sinks": int(p.sinks.count)}
    frac = genome_true_frac(contigs, genome)
    log(f"paired assembly {got}, genome-true {frac:.5f}, "
        f"{ph['clean']:.2f} s clean")
    report["phases"]["paired"].update(phase_s=ph, walk=wst,
                                      genome_true=frac, **got)
    if got != PAIRED_RECORD:
        raise AssertionError(f"paired {got} != record {PAIRED_RECORD}")
    if frac < 0.99:
        raise AssertionError(f"paired genome-true {frac:.5f} < 0.99")


# faucet_tpu (the JAX package, on the JAX CPU backend) on wide_reads():
# k = 55, two-pass file mode, Bloom mode, ext8 junctions (PERF.md)
WIDE_RECORD = {"contigs": 18, "n50": 221973, "total": 1998560,
               "junctions": 68027, "sinks": 756756}


def wide_reads():
    """The scale genome (scale_reads' generator, seed 0, 2 Mbp, 8 x 400 bp
    repeats) as 30x of 150 bp reads at 0.5% errors, circular."""
    from faucet_tpu_torch import simulate as SIM

    G = int(SCALE_MBP * 1e6)
    rng = np.random.default_rng(0)
    genome = SIM.genome_with_repeats(rng, G, n_repeats=max(4, G // 250_000),
                                     repeat_len=400)
    return genome, SIM.shred(rng, genome, coverage=30.0, read_len=150,
                             err_rate=0.005, circular=True)


@contextlib.contextmanager
def _scan_census(st):
    """While open, add up on the device the lanes of every membership
    query (st: queries, grid lanes, live lanes; st["by_shape"]: the same
    three per query shape), the set lanes of every compaction
    (st["compact"]: (set lanes, lanes, cap) per call, in call order) and
    the live lanes of every cascade insert (st["insert"]: (live lanes,
    lanes) per call)."""
    import torch

    from faucet_tpu_torch.core import bloom as BL
    from faucet_tpu_torch.kernels import compact as CP

    probe, compact = BL.cascade_solid, CP.mask_indices
    insert = BL.cascade_insert_nbs
    st.setdefault("by_shape", {})
    st.setdefault("insert", [])

    def counted(c, khi, klo, mask, cfg):
        live = mask.expand(khi.shape).sum(dtype=torch.int64)
        st["queries"] += 1
        st["grid"] += khi.numel()
        st["live"] = st["live"] + live
        q = st["by_shape"].setdefault(tuple(khi.shape), [0, 0, 0])
        q[0], q[1], q[2] = q[0] + 1, q[1] + khi.numel(), q[2] + live
        return probe(c, khi, klo, mask, cfg)

    def compacted(mask, cap):
        st["compact"].append((mask.sum(dtype=torch.int64), mask.numel(),
                              cap))
        return compact(mask, cap)

    def inserted(c, khi, klo, mask, cfg, **kw):
        st["insert"].append((mask.sum(dtype=torch.int64), mask.numel()))
        return insert(c, khi, klo, mask, cfg, **kw)

    BL.cascade_solid, CP.mask_indices = counted, compacted
    BL.cascade_insert_nbs = inserted
    try:
        yield
    finally:
        BL.cascade_solid, CP.mask_indices = probe, compact
        BL.cascade_insert_nbs = insert


@phase("wide")
def run_wide(profile: bool = False):
    """k = 55 (wide codes, the 8-way extension probe) on the 2 Mbp repeat
    genome, 30x 150 bp reads, 8,192 reads per batch, Bloom mode, two-pass
    file mode, sized as scale_config sizes phase 5: WIDE_RECORD exactly,
    >= 99% genome-true. Prints the phases' seconds, walk ms per step, B1's
    lanes per scan batch, the share of set lanes B7 compacts (junctions,
    sinks) and the peak device memory."""
    import torch

    from faucet_tpu_torch.graph import walk as W
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    t0 = time.perf_counter()
    genome, reads = wide_reads()
    log(f"{SCALE_MBP} Mbp genome, {len(reads)} reads of 150 bp synthesized "
        f"in {time.perf_counter() - t0:.2f} s")
    cfg = scale_config(len(genome), len(reads), k=55, read_len=150)
    assert cfg.wide and not cfg.use_node_junctions
    torch.cuda.reset_peak_memory_stats()
    p = Pipeline(cfg, counted_metrics(), device="cuda")
    ph, lanes = {}, {"queries": 0, "grid": 0, "live": 0, "compact": []}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        ph[name] = time.perf_counter() - t
        log(f"  {name}: {ph[name]:.2f} s")
        return r

    orig_w, wrapped, wst = _walk_timer(20 if profile else None,
                                       "walk_round_wide")
    W.walk_round_wide = wrapped
    try:
        timed("load", lambda: p.load_batches(batch_iter(reads, cfg)))
        with _scan_census(lanes):
            timed("scan", lambda: p.scan_batches(batch_iter(reads, cfg)))
        g = timed("graph_build", p.build)
        g = timed("clean", lambda: p.clean_graph(g))
    finally:
        W.walk_round_wide = orig_w
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-len(reads) // cfg.batch_reads)
    lanes["live"] = int(lanes["live"])
    # per batch the junction lanes are compacted, then the sink lanes
    comp = lanes.pop("compact")
    share = {name: sum(int(c[0]) for c in comp[i::2])
             / max(sum(c[1] for c in comp[i::2]), 1)
             for i, name in enumerate(("junction", "sink"))}
    contigs = [g.contigs[i].seq for i in g.live()]
    lens = [len(c) for c in contigs]
    got = {"contigs": len(contigs), "n50": n50(lens), "total": sum(lens),
           "junctions": int(p.junctions.count), "sinks": int(p.sinks.count)}
    frac = genome_true_frac(contigs, genome)
    ms_step = 1e3 * wst["seconds"] / max(wst["steps"], 1)
    # the extension keys: one launch a scan batch (zero_counts ran just
    # before this phase)
    tally = launch_tally()
    wide_ext = None if tally is None else tally.get("wide_ext_launches", 0)
    log(f"wide_ext launches {wide_ext}, scan batches {n_batches}")
    if wide_ext not in (None, n_batches):
        raise AssertionError(f"wide_ext launches {wide_ext} != "
                             f"{n_batches} scan batches")
    log(f"wide assembly {got}, genome-true {frac:.5f}; walk: "
        f"{wst['rounds']} rounds, {wst['steps']} steps timed in "
        f"{wst['seconds']:.2f} s, {ms_step:.3f} ms/step")
    log(f"B1 per scan batch: {lanes['queries'] / n_batches:.1f} queries, "
        f"{lanes['grid'] / n_batches:.0f} lanes, "
        f"{lanes['live'] / n_batches:.0f} live; B7: {len(comp)} calls, "
        f"junction lanes {share['junction']:.4f} and sink lanes "
        f"{share['sink']:.4f} of the grid; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    report["phases"]["wide"].update(
        phase_s=ph, walk=wst, walk_ms_per_step=ms_step, genome_true=frac,
        b1_per_scan_batch={x: lanes[x] / n_batches
                           for x in ("queries", "grid", "live")},
        b7_set_share=share, wide_ext_launches=wide_ext,
        peak_bytes=peak, **got)
    if got != WIDE_RECORD:
        raise AssertionError(f"wide {got} != record {WIDE_RECORD}")
    if frac < 0.99:
        raise AssertionError(f"wide genome-true {frac:.5f} < 0.99")


def _wide_apart(root, profile: bool, t_start: float):
    """The wide phase in a process of its own (run beside the paired
    phase): its record, and its launch counts from just before it to just
    after it."""
    global LOG_TAG, T_START
    LOG_TAG, T_START = "[wide] ", t_start
    if root not in sys.path:
        sys.path.insert(0, root)
    report["phases"]["wide"] = {}
    zero_counts()
    run_wide(profile)
    return report["phases"]["wide"], read_counts(), read_variants()


# faucet_tpu (the JAX package, on the JAX CPU backend) on scale_reads():
# the k = 31 two-pass assembly, its contigs chunked by contig_chunks(g,
# 100, 55), then a k = 55 two-pass run over the reads and the chunks,
# Bloom mode, ext8 junctions, cleaned (PERF.md)
DUALK_RECORD = {"contigs": 18, "n50": 221973, "total": 1998560,
                "junctions": 63739, "sinks": 950421}


@phase("dualk")
def run_dualk(pass1=None):
    """Configuration 2 (BASELINE.md: k = 31, then k = 55) at full width:
    phase 5's k = 31 graph (pass1: its genome, reads, cfg and cleaned
    graph; built here when phase 5 did not run), chunked by contig_chunks to 100 bp, then a second Pipeline at
    dataclasses.replace(cfg, size_kmer=55) whose load and scan are each fed
    the read batches and then the chunk batches, as the CLI's -second_kmer
    does: DUALK_RECORD exactly, >= 99% genome-true."""
    import dataclasses
    import itertools

    import torch

    from faucet_tpu_torch.graph import walk as W
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter, contig_chunks

    ph = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        ph[name] = time.perf_counter() - t
        log(f"  {name}: {ph[name]:.2f} s")
        return r

    torch.cuda.reset_peak_memory_stats()
    if pass1 is not None:
        log("first pass: phase 5's k = 31 graph")
        genome, reads, cfg, g = pass1
    else:
        genome, reads = scale_reads()
        cfg = scale_config(len(genome), len(reads))
        p = Pipeline(cfg, counted_metrics(), device="cuda")
        g = timed("pass1", lambda: p.run_file_mode(reads, reads))
        del p
        lens = [len(g.contigs[i].seq) for i in g.live()]
        got = {"contigs": len(lens), "n50": n50(lens), "total": sum(lens)}
        if got != SCALE_RECORD:
            raise AssertionError(f"pass 1 {got} != record {SCALE_RECORD}")
    chunks = contig_chunks(g, cfg.max_read_length, 55)
    cfg2 = dataclasses.replace(cfg, size_kmer=55)
    assert cfg2.wide and not cfg2.use_node_junctions
    B = cfg2.batch_reads
    n_batches = (-(-len(reads) // B), -(-len(chunks) // B))
    log(f"{len(chunks) // 2} contig chunks (each twice); second pass "
        f"batches: {n_batches[0]} of reads, {n_batches[1]} of chunks")
    p2 = Pipeline(cfg2, counted_metrics(), device="cuda")

    def batches():
        return itertools.chain(batch_iter(reads, cfg2),
                               batch_iter(chunks, cfg2))

    orig_w, wrapped, wst = _walk_timer(name="walk_round_wide")
    W.walk_round_wide = wrapped
    st = {"queries": 0, "grid": 0, "live": 0, "compact": []}
    try:
        with _scan_census(st):
            timed("load", lambda: p2.load_batches(batches()))
            timed("scan", lambda: p2.scan_batches(batches()))
        g2 = timed("graph_build", p2.build)
        g2 = timed("clean", lambda: p2.clean_graph(g2))
    finally:
        W.walk_round_wide = orig_w
    peak = torch.cuda.max_memory_allocated()
    contigs = [g2.contigs[i].seq for i in g2.live()]
    lens = [len(c) for c in contigs]
    got = {"contigs": len(contigs), "n50": n50(lens), "total": sum(lens),
           "junctions": int(p2.junctions.count),
           "sinks": int(p2.sinks.count)}
    frac = genome_true_frac(contigs, genome)
    ms_step = 1e3 * wst["seconds"] / max(wst["steps"], 1)
    log(f"dual-k assembly {got}, genome-true {frac:.5f}; walk: "
        f"{wst['rounds']} rounds, {wst['steps']} steps timed in "
        f"{wst['seconds']:.2f} s, {ms_step:.3f} ms/step; peak device "
        f"memory {peak / 2**30:.3f} GiB")
    shapes = _second_pass_shapes(st, cfg2)
    log(f"second pass, the kernels' shapes and live shares: {shapes}")
    report["phases"]["dualk"].update(
        phase_s=ph, chunks=len(chunks), batches=n_batches, walk=wst,
        walk_ms_per_step=ms_step, genome_true=frac, peak_bytes=peak,
        kernel_shapes=shapes, **got)
    if got != DUALK_RECORD:
        raise AssertionError(f"dual-k {got} != record {DUALK_RECORD}")
    if frac < 0.99:
        raise AssertionError(f"dual-k genome-true {frac:.5f} < 0.99")
    return shapes


def _second_pass_shapes(st, cfg2) -> dict:
    """What B1, B2 and B7 saw in the dual-k second pass (a census of its
    load and scan): each probe shape with its live share, the load's lanes
    per insert and their live share with the filters' sizes and hash
    counts, and the compacted grid with its cap and the junction and sink
    shares (per scan batch the junction lanes are compacted, then the sink
    lanes)."""
    probes = [(list(shape), q[2].item() / max(q[1], 1))
              for shape, q in st["by_shape"].items()]
    ins, comp = st["insert"], st["compact"]
    if len({n for _, n in ins}) != 1 or len({c[1:] for c in comp}) != 1:
        raise AssertionError("dual-k second pass: batches of mixed shapes")
    return {"probe": probes,
            "insert": {"n": ins[0][1],
                       "live": sum(int(c) for c, _ in ins)
                       / sum(n for _, n in ins),
                       "la": cfg2.bloom_a_bits.bit_length() - 1,
                       "lb": cfg2.bloom_b_bits.bit_length() - 1,
                       "nha": cfg2.n_hash_a, "nhb": cfg2.n_hash_b},
            "compact": {"n": comp[0][1], "cap": comp[0][2],
                        **{name: sum(int(c[0]) for c in comp[i::2])
                           / sum(c[1] for c in comp[i::2])
                           for i, name in enumerate(("junction", "sink"))}}}


@phase("dualk_kernels")
def run_dualk_kernels(shapes):
    """B1, B2 and B7 against their plain versions at the dual-k second
    pass's own shapes and live shares (phase 6c's census): its window and
    8-way extension probes, its load batch into its filters (phase 5's
    sizes at k = 55: A 2**27 bits, n_hash 7; B 2**25, n_hash 3) from a
    pool of ~2 M k-mers, and its scan grid's compaction, cap = N, at the
    junction and sink shares."""
    import torch

    from faucet_tpu_torch.kernels import build as KB

    lib = KB.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    res = check_probe(gen, dev, lib, [
        (tuple(shape), tuple(shape), round(share, 4))
        for shape, share in shapes["probe"]], prefix="probe_dualk_")
    ins = shapes["insert"]
    tag = (f"dual-k pass 2 dense 2**{ins['la']}/2**{ins['lb']} bits, "
           f"n_hash {ins['nha']}/{ins['nhb']}")
    res["cascade_dualk"] = _cascade_case(
        dev, lib, tag, ins["la"], ins["lb"], ins["nha"], ins["nhb"],
        _pool_batches(gen, dev, ins["n"], round(ins["live"], 4)))
    cp = shapes["compact"]
    res.update(check_compact(gen, dev, lib, [
        (cp["n"], round(cp[x], 4), cp["cap"]) for x in ("junction", "sink")],
        prefix="compact_dualk_", epoch_run=False))
    report.setdefault("kernels", {}).update(res)


CLI_MODES = ("two_pass", "stream", "paired", "wide")


def run_together(jobs: dict, d: str, timeout: float):
    """Start every job at once, each a process of its own in a session of
    its own, and wait for all. jobs: name -> (command, stdin file or None,
    extra environment); standard output and error go to files under d.
    Returns (name -> (return code, stdout, stderr, seconds from the start
    to its exit), the rank processes still running once all have exited).
    Every process a job started is stopped before it returns."""
    import signal

    procs, files = {}, []
    t0 = time.perf_counter()
    try:
        for name, (cmd, stdin, env) in jobs.items():
            io = [open(os.path.join(d, f"{name}.{x}"), "w")
                  for x in ("out", "err")]
            io.append(open(stdin, "rb") if stdin else subprocess.DEVNULL)
            files += [f for f in io if f is not subprocess.DEVNULL]
            procs[name] = subprocess.Popen(
                cmd, cwd=ROOT, stdin=io[2], stdout=io[0], stderr=io[1],
                env=dict(os.environ, **env), start_new_session=True)
        done = {}
        while len(done) < len(procs):
            for name, p in procs.items():
                if name not in done and p.poll() is not None:
                    done[name] = time.perf_counter() - t0
                    note(f"cli {name}: exit {p.returncode} after "
                         f"{done[name]:.1f} s")
            if time.perf_counter() - t0 > timeout:
                raise RuntimeError(f"cli runs {sorted(set(procs) - set(done))}"
                                   f" did not finish within {timeout:.0f} s")
            time.sleep(0.1)
        left = _spawned_ranks()
    finally:
        for p in procs.values():
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        for f in files:
            f.close()
    read = lambda name, x: open(os.path.join(d, f"{name}.{x}")).read()
    return {name: (p.returncode, read(name, "out"), read(name, "err"),
                   done[name]) for name, p in procs.items()}, left


@phase("cli")
def run_cli(sharded: bool = False):
    """The CLI runs (CLI_MODES on phase 7's reads and mates, the dual-k
    --profile run on phase 4's reads, and with `sharded` the dist phase's
    part (d)) start together, each a process of its own with
    OMP_NUM_THREADS set to its share of the CPUs, and are checked once
    all have exited."""
    from faucet_tpu_torch.dist.mesh import usable_cpus
    from faucet_tpu_torch.out.fasta import read_fasta

    genome, reads, SIM = cli_reads()
    # 15x per mate: the same 30x of reads as the unpaired runs
    mates = shred(SIM, np.random.default_rng(CLI_MATES_SEED), genome, True,
                  coverage=15.0)
    with tempfile.TemporaryDirectory() as d:
        fa, fp = os.path.join(d, "reads.fa"), os.path.join(d, "mates.fa")
        SIM.write_fasta(fa, reads)
        SIM.write_fasta(fp, mates)
        jobs = {}
        # "wide": -size_kmer 55 (wide codes, ext8 junctions), two-pass
        for mode in CLI_MODES:
            prefix = os.path.join(d, mode)
            src = fp if mode == "paired" else fa
            k = 55 if mode == "wide" else 31
            cfg = scale_config(len(genome), len(reads), k=k)
            cmd = [sys.executable, "-m", "faucet_tpu_torch.cli",
                   "-read_load_file", src, "-size_kmer", str(k),
                   "-max_read_length", "100",
                   "-estimated_kmers", str(cfg.estimated_kmers),
                   "-singletons", str(cfg.singletons),
                   "--batch_reads", "8192", "-file_prefix", prefix]
            cmd += (["--stream"] if mode == "stream"
                    else ["-read_scan_file", src])
            cmd += ["--paired_ends"] if mode == "paired" else []
            jobs[mode] = (cmd, None, {})
        jobs["dualk"] = _cli_dualk_job(d)
        if sharded:
            jobs["sharded"] = (_cli_cmd(fa, os.path.join(d, "sharded"),
                                        genome, len(reads))
                               + ["--n_shards", str(DIST_SHARDS)], None, {})
        threads = str(max(1, usable_cpus() // 4))
        for job in jobs.values():
            job[2]["OMP_NUM_THREADS"] = threads
        res, left = run_together(jobs, d, timeout=900)
        for mode in CLI_MODES:
            prefix = os.path.join(d, mode)
            rc, _, err, secs = res[mode]
            if rc:
                raise RuntimeError(f"cli {mode} failed ({rc}):\n"
                                   + err[-3000:])
            for ext in ("fasta", "gfa", "bloom.npz", "junctions.npz"):
                if not os.path.getsize(f"{prefix}.{ext}"):
                    raise AssertionError(f"cli {mode}: empty {ext}")
            paired = "p_keys_hi" in np.load(f"{prefix}.junctions.npz")
            if paired != (mode == "paired"):
                raise AssertionError(f"cli {mode}: pair table in the "
                                     f"checkpoint: {paired}")
            contigs = [s for _, s in read_fasta(f"{prefix}.fasta")]
            frac = genome_true_frac(contigs, genome)
            total = sum(len(c) for c in contigs)
            native = "native C++ reader" in err
            log(f"{mode}: {len(contigs)} contigs, N50 "
                f"{n50([len(c) for c in contigs])}, {total} bases, "
                f"genome-true {frac:.5f}, {secs:.2f} s"
                f"{' (native reader)' if native else ''}")
            if frac < 0.99:
                raise AssertionError(f"cli {mode}: genome-true {frac}")
            got = {"contigs": len(contigs),
                   "n50": n50([len(c) for c in contigs]), "total": total}
            if mode in ("two_pass", "paired") and \
                    total < 0.99 * len(genome):
                raise AssertionError(f"cli {mode}: {total} bases of "
                                     f"{len(genome)}")
            if mode == "paired" and got != CLI_PAIRED_RECORD:
                raise AssertionError(f"cli paired: {got} != record "
                                     f"{CLI_PAIRED_RECORD}")
            report["phases"]["cli"][mode] = {
                "contigs": len(contigs), "bases": total, "genome_true": frac,
                "seconds": secs}
            if mode == "two_pass":  # the dist phase's CLI run matches it
                CLI_TWO_PASS["fasta"] = open(f"{prefix}.fasta", "rb").read()
        _cli_dualk_check(d, res["dualk"])
        if sharded:
            rc, _, err, secs = res["sharded"]
            if rc:
                raise RuntimeError(f"(d) sharded cli failed ({rc}):\n"
                                   + err[-3000:])
            DIST_CLI["d"] = _dist_cli_check(
                open(os.path.join(d, "sharded.fasta"), "rb").read(), secs,
                left)


def _kernel_names() -> dict:
    """csrc file -> the names of its __global__ functions."""
    import re

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)\s*\(")
    src = os.path.join(ROOT, "faucet_tpu_torch", "csrc")
    return {f: pat.findall(open(os.path.join(src, f)).read())
            for f in sorted(os.listdir(src)) if f.endswith(".cu")}


def _cli_dualk_job(d):
    """-size_kmer 31 -second_kmer 55 --profile on phase 4's reads, the
    load reads fed on stdin, TMPDIR a fresh directory: run_together's
    job."""
    from faucet_tpu_torch import simulate as SIM

    fa, prefix = os.path.join(d, "parity.fa"), os.path.join(d, "dualk")
    tmp = os.path.join(d, "tmp")
    os.makedirs(tmp)
    SIM.write_fasta(fa, parity_case()[1])
    cmd = [sys.executable, "-m", "faucet_tpu_torch.cli", "-read_load_file",
           "-", "-read_scan_file", fa, "-size_kmer", "31", "-second_kmer",
           "55", "-max_read_length", "100", "-estimated_kmers",
           str(1 << 16), "-singletons", str(1 << 17), "-fp_rate", "0.002",
           "--batch_reads", "2048", "--profile", "-file_prefix", prefix]
    return cmd, fa, {"TMPDIR": tmp}


def _cli_dualk_check(d, res):
    """The dual-k run: exit 0, the spool and second-pass lines, no spool
    file left in TMPDIR, >= 99% genome-true, and a Chrome trace in
    {prefix}.trace/ holding CUDA kernel events of the probe, cascade and
    compaction kernels (found by their names in csrc/)."""
    from faucet_tpu_torch.out.fasta import read_fasta

    genome = parity_case()[0]
    prefix, tmp = os.path.join(d, "dualk"), os.path.join(d, "tmp")
    rc, _, err, secs = res
    if rc:
        raise RuntimeError(f"cli dualk failed ({rc}):\n" + err[-3000:])
    for line in ("dual-k on a pipe: spooled load reads to ",
                 "dual-k second pass at k=55", "profile trace in "):
        if line not in err:
            raise AssertionError(f"cli dualk: no {line!r} line")
    left = [f for f in os.listdir(tmp)
            if f.startswith("faucet_tpu_torch_spool_")]
    if left:
        raise AssertionError(f"cli dualk: spool files left: {left}")
    contigs = [s for _, s in read_fasta(f"{prefix}.fasta")]
    frac = genome_true_frac(contigs, genome)
    trace = os.path.join(f"{prefix}.trace", "trace.json")
    t1 = time.perf_counter()
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    found = {}
    for src, names in _kernel_names().items():
        found[src] = {n: sum(n in e for e in kernels) for n in names}
    log(f"dualk (stdin, --profile): {len(contigs)} contigs, "
        f"{sum(map(len, contigs))} bases, genome-true {frac:.5f}, "
        f"{secs:.2f} s; trace {os.path.getsize(trace)} B, {len(events)} "
        f"events, {len(kernels)} kernel events (read in "
        f"{time.perf_counter() - t1:.2f} s): {found}")
    report["phases"]["cli"]["dualk"] = {
        "contigs": len(contigs), "bases": sum(map(len, contigs)),
        "genome_true": frac, "seconds": secs, "trace_events": len(events),
        "kernel_events": found}
    if frac < 0.99:
        raise AssertionError(f"cli dualk: genome-true {frac}")
    for src in ("probe.cu", "cascade.cu", "compact.cu"):
        if not any(found[src].values()):
            raise AssertionError(f"cli dualk: no kernel of {src} in the "
                                 "trace")


@phase("stream")
def run_stream(n_batches: int = 16, warmup: int = 2, groups: int = 5,
               profile: bool = False):
    import torch

    from faucet_tpu_torch import Config
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
    from faucet_tpu_torch.kernels import compact as KCP

    kernel = KCP.mask_indices

    def run(compact):
        """One stream of the batches, upsert rounds compacted by
        `compact`; returns (reads/s, junction and sink arrays)."""
        KCP.mask_indices = compact
        try:
            p = Pipeline(cfg, counted_metrics(), device="cuda")
            for bases, lens in batches[:warmup]:
                p.stream_step(bases, lens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for bases, lens in batches[warmup:]:
                p.stream_step(bases, lens)
            p.flush_junctions()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            KCP.mask_indices = kernel
        return (n_batches * B / dt,
                _table_arrays(p.junctions) + _table_arrays(p.sinks), p)

    # the path, counted: one stream with the compaction kernel
    zero_counts()
    rate, tk, p = run(kernel)
    report["launches_by_path"]["stream"] = read_counts()
    log(f"{n_batches} batches x {B} reads: {rate:.0f} reads/s (load+scan, "
        f"after {warmup} warmup batches)")
    # the upsert rounds' compaction, kernel against its plain version
    # (same batches, a fresh Pipeline each run) in ABBA order
    rates = {"kernel": [rate], "plain": []}
    order = ["plain", "plain", "kernel"] + ["kernel", "plain", "plain",
                                            "kernel"] * (groups - 1)
    for name in order:
        r, tables, _ = run(kernel if name == "kernel"
                           else KCP.mask_indices_plain)
        rates[name].append(r)
        if not all(np.array_equal(x, y) for x, y in zip(tk, tables)):
            raise AssertionError(f"stream: the {name} compaction's junction "
                                 "and sink tables differ")
    pairs = list(zip(rates["kernel"], rates["plain"]))
    rec = {"batches": n_batches, "reads_per_s": rate, "runs": rates,
           "kernel_won": sum(k > q for k, q in pairs), "pairs": len(pairs)}
    for name, xs in rates.items():
        q1, med, q3 = np.percentile(xs, [25, 50, 75])
        rec[name] = {"median": med, "q1": q1, "q3": q3}
        log(f"compaction {name}: {len(xs)} runs, median {med:.0f} reads/s "
            f"(quartiles {q1:.0f}-{q3:.0f}, range {min(xs):.0f}-"
            f"{max(xs):.0f})")
    log(f"stream: identical tables in all {len(order) + 1} runs; the "
        f"kernel won {rec['kernel_won']} of {len(pairs)} pairs")
    report["phases"]["stream"].update(rec)
    if profile:
        report["phases"]["stream"]["profiled"] = log_share(
            "4 stream batches", *device_share(
                lambda: [p.stream_step(b, n) for b, n in batches[-4:]]))


# B7's wrapper calls on the scale / paired / stream paths when
# upsert_rounds compacted once per round and the spool append sorted
# instead (the earlier design's full smoke; PERF.md)
COMPACT_CALLS_BEFORE = {"scale": 222, "paired": 614, "stream": 51}


def launch_census():
    """Device launches of one call of each redesigned entry point at a
    main-path shape, from torch.profiler (after every timed phase): the
    membership query on the walk's [4, 8192] frame, the cascade insert of
    a dense load batch into the 2 Mbp run's filters, the compaction of a
    scan grid with every live lane taken (as upsert_rounds and the spool
    append call it), and bloom_insert into the 16 MB filter."""
    import torch

    from faucet_tpu_torch.core import bloom as BL
    from faucet_tpu_torch.kernels import compact as KCP

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cfg = scale_config(2_000_000, 600_000)
    c = BL.make_cascade(cfg, dev)
    hi, lo = _rand_keys(gen, 4 * 8192, dev)
    m = torch.rand((8192,), generator=gen, device=dev) < 0.9
    n_probe, rows_p = device_launches(lambda: BL.cascade_solid(
        c, hi.view(4, -1), lo.view(4, -1), m, cfg))
    hi, lo = _rand_keys(gen, 573_440, dev)
    m = torch.rand((573_440,), generator=gen, device=dev) < 0.97
    n_cascade, rows_c = device_launches(
        lambda: BL.cascade_insert_nbs(c, hi, lo, m, cfg))
    jm = torch.rand((573_440,), generator=gen, device=dev) < 0.015
    n_compact, rows_m = device_launches(
        lambda: KCP.mask_indices(jm, 573_440))
    b = BL.make_bloom(27, dev)
    n_insert, rows_i = device_launches(
        lambda: BL.bloom_insert(b, hi, lo, m, 4, 27))
    rec = {"cascade_solid": n_probe, "cascade_insert_nbs": n_cascade,
           "mask_indices": n_compact, "bloom_insert": n_insert}
    report["launch_census"] = dict(rec, rows={
        "cascade_solid": rows_p, "cascade_insert_nbs": rows_c,
        "mask_indices": rows_m, "bloom_insert": rows_i})
    log(f"[counters] device launches per call: {rec}")
    for us, name, cnt in rows_p + rows_c + rows_m + rows_i:
        log(f"    {us:9.1f} us  x{cnt:<3} {name}")
    by_path = report["launches_by_path"]
    log("[counters] mask_indices calls by path, this tree / per-round "
        "compaction: "
        + ", ".join(f"{p} {c['compact']} / {COMPACT_CALLS_BEFORE.get(p)}"
                    for p, c in by_path.items()))
    if n_probe != 1 or n_cascade > 3 or n_compact != 1 or n_insert != 1:
        raise AssertionError(f"device launches per call: {rec}")


def kernel_line(launches, variants, origin):
    """One record per TPU kernel (B1-B7). B2, B3 and B4 are the three
    Pallas variants of cascade_insert_fused, all replaced by
    csrc/cascade.cu; each record counts the launches that stood in for its
    variant (the tally's `cascade_<variant>_launches`, kernels/cascade.py).
    The reference takes its
    multi-tile variant (B4) only for a filter A larger than one tile,
    which the dual-k path's is not: B4's launches are the wide path's."""
    k = report.get("kernels", {})
    by_path = report["launches_by_path"]
    by_variant = report["cascade_variants_by_path"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms")

    def entry(name, source, replaces, rows, row, count, origin, per_path):
        errs = [r["max_abs_err"] for r in rows]
        e = {"name": name, "route": "cuda",
             "source": f"faucet_tpu_torch/csrc/{source}",
             "replaces": f"faucet_tpu/kernels/{replaces}",
             "launches": count, "launches_from": origin,
             "max_abs_err": max(errs) if errs else None,
             **{x: row.get(x) for x in keys}}
        if per_path is not None:
            e["launches_by_path"] = per_path
        return e

    def rows(prefix):
        return [r for key, v in k.items() if key.startswith(prefix)
                for r in (v if isinstance(v, list) else [v])]

    def sample(prefix, fallback):
        """The dist path's record (its largest shape), else the dual-k
        pass's, else fallback."""
        got = rows("probe_dist_") or rows(prefix)
        if not got:
            return k.get(fallback) or {}
        return max(got, key=lambda r: int(np.prod(r.get("shape", [1]))))

    first = lambda key: (k.get(key) or [{}])[0]
    path = lambda key: {p: c[key] for p, c in by_path.items()}
    variant = lambda v: {p: c.get(v) for p, c in by_variant.items()}
    entries = "the entries phase (no caller on any path)"
    cascade_dense = (k.get("cascade_dist") or k.get("cascade_dualk")
                     or k.get("cascade_dense_27_25_7_3") or [{}])[0]
    return {"kernels": [
        entry("bloom_contains_codes", "probe.cu", "probe.py:98",
              rows("probe"), sample("probe_dualk_", "probe_4x8192"),
              launches.get("probe"), origin, path("probe")),
        entry("cascade_insert", "cascade.cu", "cascade.py:470",
              rows("cascade_dense") + rows("cascade_dualk")
              + rows("cascade_dist"), cascade_dense,
              variants.get("dense"), origin, variant("dense")),
        entry("cascade_insert (sparse lanes)", "cascade.cu",
              "cascade.py:270",
              rows("cascade_sparse") + rows("cascade_wide_sparse"),
              first("cascade_sparse_27_25_3_3"), variants.get("sparse"),
              origin + ": the node-endpoint inserts of its k = 31 pass",
              variant("sparse")),
        entry("cascade_insert (multi-tile filters)", "cascade.cu",
              "cascade.py:53", rows("cascade_wide_dense"),
              first("cascade_wide_dense_28_25_5_3"),
              by_variant.get("wide", {}).get("multi_tile"),
              "the wide path (k = 55, filter A 2**28 bits): the dual-k "
              "path's filters fit the reference's one tile",
              variant("multi_tile")),
        entry("bloom_insert_codes", "bloom_scatter.cu",
              "bloom_scatter.py:124", rows("insert_codes"),
              k.get("insert_codes_A", {}),
              launches.get("bloom_insert_codes"), entries, None),
        entry("scatter_or_bits", "bloom_scatter.cu", "bloom_scatter.py:166",
              rows("scatter_bits"), k.get("scatter_bits", {}),
              launches.get("scatter_or_bits"), entries, None),
        entry("mask_indices", "compact.cu", "compact.py:56",
              rows("compact"),
              (rows("compact_dist_") or rows("compact_dualk_")
               or [k.get("compact_786432_0.027_786432", {})])[0],
              launches.get("compact"), origin, path("compact"))]}


# ---- dist: hash-range sharding, one process per shard ---------------------

DIST_SHARDS = 4
DIST_PARTS = "a,b,c,d,e"
# the reference's CLI (faucet_tpu, JAX CPU backend, --no_native) with
# part (d)'s arguments: its FASTA at --n_shards 4 on phase 7's reads. It
# holds the unsharded run's contig set, one contig reverse-complemented
# (PERF.md, PR 7)
CLI_SHARDED_FASTA_SHA256 = ("52b146ad665fe9be6381c1e355f92f4d"
                            "7f84e498349f0b65076a808b3720f163")
# phase 7's two-pass FASTA, kept for the dist phase's CLI run (d)
CLI_TWO_PASS = {}
# part (d)'s record when the cli phase ran it beside its own runs
DIST_CLI = {}


def _compute_mode() -> str:
    """The card's compute mode; an exclusive mode lets one process use the
    card, and the dist phase runs four ranks on it."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"compute mode: {mode}")
    if "exclusive" in mode.lower():
        raise RuntimeError(f"compute mode {mode!r}: {DIST_SHARDS} ranks "
                           "cannot share the card (set it to Default)")
    return mode


def _np_tables(sp, names=("junctions", "sinks")) -> dict:
    """Global tables (rank slices in rank order) as numpy arrays, TRASH
    row dropped (collective: every rank calls it)."""
    from faucet_tpu_torch.dist.sharded import gather_table

    out = {}
    for name in names:
        t = gather_table(sp.mesh, getattr(sp, name))
        out[name] = [a.cpu().numpy() for a in
                     (t.keys_hi[:-1], t.keys_lo[:-1],
                      *(v[:-1] for v in t.vals))]
    return out


def _single_tables(p, names=("junctions", "sinks")) -> dict:
    return {name: [a.cpu().numpy() for a in
                   (t.keys_hi[:-1], t.keys_lo[:-1],
                    *(v[:-1] for v in t.vals))]
            for name in names for t in [getattr(p, name)]}


def _table_content(cols) -> dict:
    """key -> values of a numpy table's occupied rows."""
    hi, lo = cols[0], cols[1]
    occ = np.nonzero(hi != -1)[0]
    return {(int(hi[i]), int(lo[i])): tuple(
        np.asarray(v[i]).astype(np.int64).tobytes() for v in cols[2:])
        for i in occ}


def _same_tables(a: dict, b: dict):
    """(slot arrays identical, content identical) over every table."""
    slots = all(len(a[n]) == len(b[n]) and all(
        np.array_equal(x, y) for x, y in zip(a[n], b[n])) for n in a)
    content = all(_table_content(a[n]) == _table_content(b[n]) for n in a)
    return slots, content


def _dist_shapes(st, cfg_local) -> dict:
    """What B1, B2 and B7 saw on one rank of the sharded load and scan (a
    census): each probe shape (the lanes an owner answers) with its live
    share, the dense load insert (the most-live one) with its filters'
    sizes and hash counts, and the compacted scan grid with its cap and
    the junction and sink shares."""
    probes = [(list(shape), q[2].item() / max(q[1], 1))
              for shape, q in st["by_shape"].items()]
    ins = [(int(c), n) for c, n in st["insert"]]
    dense_n = max(ins, key=lambda x: x[0] / max(x[1], 1))[1]
    dense = [(c, n) for c, n in ins if n == dense_n]
    comp = [(int(c), n, cap) for c, n, cap in st["compact"]]
    return {"probe": probes,
            "insert": {"n": dense_n,
                       "live": sum(c for c, _ in dense)
                       / sum(n for _, n in dense),
                       "la": cfg_local.bloom_a_bits.bit_length() - 1,
                       "lb": cfg_local.bloom_b_bits.bit_length() - 1,
                       "nha": cfg_local.n_hash_a, "nhb": cfg_local.n_hash_b},
            "compact": {"n": comp[0][1], "cap": comp[0][2],
                        **{name: sum(c[0] for c in comp[i::2])
                           / sum(c[1] for c in comp[i::2])
                           for i, name in enumerate(("junction", "sink"))}}}


def _dist_scale_rank(mesh):
    """One rank of part (a): the 2 Mbp scale run at n_shards ranks."""
    import dataclasses

    import torch

    from faucet_tpu_torch.dist import swalk as SW
    from faucet_tpu_torch.dist.sharded import ShardedPipeline
    from faucet_tpu_torch.pipeline import batch_iter

    dev = mesh.device
    genome, reads = scale_reads()
    cfg = dataclasses.replace(scale_config(len(genome), len(reads)),
                              n_shards=mesh.n_shards)
    torch.cuda.reset_peak_memory_stats(dev)
    sp = ShardedPipeline(cfg, mesh, counted_metrics())
    ph, coll = {}, {}

    def timed(name, fn):
        s0 = dict(mesh.stats)
        mesh.barrier()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(dev)
        mesh.barrier()
        ph[name] = time.perf_counter() - t
        coll[name] = {k: mesh.stats[k] - s0[k] for k in s0}
        return r

    census = {"queries": 0, "grid": 0, "live": 0, "compact": []}
    orig, wrapped, wst = _walk_timer(name="walk_round_routed", module=SW)
    zero_counts()
    SW.walk_round_routed = wrapped
    try:
        with _scan_census(census):
            timed("load", lambda: sp.load_batches(batch_iter(reads, cfg)))
            timed("scan", lambda: sp.scan_batches(batch_iter(reads, cfg)))
        g = timed("graph_build", sp.build)
        g = timed("clean", lambda: sp.clean_graph(g))
    finally:
        SW.walk_round_routed = orig
    counts, variants = read_counts(), read_variants()
    out = {"counts": counts, "variants": variants, "phase_s": ph,
           "collectives": coll, "walk": wst,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "route_bytes": sp.metrics.counters.get("walk_route_bytes", 0),
           "batches": -(-len(reads) // cfg.batch_reads)}
    tables = _np_tables(sp)
    if mesh.rank == 0:
        out.update(contigs=[g.contigs[i].seq for i in g.live()],
                   tables=tables, genome=genome,
                   shapes=_dist_shapes(census, cfg.local_shard()),
                   metrics=dict(sp.metrics.counters))
    return out


def _dist_parity_configs():
    """Part (b)'s cases: (name, Config kwargs, input, paired, clean both
    ways): phase 4's parity config at k = 21 and 55, Bloom and exact; the
    phased repeat, paired; the k = 21 Bloom run is also cleaned by the
    halo-exchange cleaner (--distributed_clean)."""
    parity = dict(max_read_length=100, batch_reads=2048,
                  estimated_kmers=1 << 16, singletons=1 << 17,
                  junction_capacity=1 << 14, sink_capacity=1 << 17,
                  fp_rate=0.002, n_shards=DIST_SHARDS)
    paired = dict(size_kmer=21, max_read_length=80, batch_reads=128,
                  estimated_kmers=1 << 15, singletons=1 << 15,
                  junction_capacity=1 << 13, sink_capacity=1 << 14,
                  pair_capacity=1 << 14, paired_ends=True,
                  n_shards=DIST_SHARDS)
    return [("k21", dict(parity, size_kmer=21), "parity", False, True),
            ("k55", dict(parity, size_kmer=55), "parity", False, False),
            ("exact_k21", dict(parity, size_kmer=21, exact=True), "parity",
             False, False),
            ("exact_k55", dict(parity, size_kmer=55, exact=True), "parity",
             False, False),
            ("paired", paired, "phased", True, False)]


def _dist_parity_rank(mesh):
    """One rank of part (b): every parity case at n_shards ranks. Returns
    per case the gathered tables (rank 0) and the contig sets (every
    rank: each builds the graph)."""
    import copy
    import dataclasses

    from faucet_tpu_torch import Config
    from faucet_tpu_torch.dist.sharded import ShardedPipeline

    inputs = {"parity": parity_case()[1], "phased": phased_case()[0]}
    out = {}
    for name, kw, inp, paired, both_cleans in _dist_parity_configs():
        t0 = time.perf_counter()
        reads = inputs[inp]
        sp = ShardedPipeline(Config(**kw), mesh, counted_metrics())
        sp.load_reads(reads)
        (sp.scan_paired if paired else sp.scan_reads)(reads)
        g = sp.build()
        names = ("junctions", "sinks", "pairs") if paired else \
            ("junctions", "sinks")
        tables = _np_tables(sp, names)
        keys = lambda g: sorted(g.contigs[i].canonical_seq()
                                for i in g.live())
        rec = {"raw": keys(g), "s": time.perf_counter() - t0}
        if both_cleans:
            cfg = sp.cfg
            sp.cfg = dataclasses.replace(cfg, distributed_clean=True)
            rec["halo"] = keys(sp.clean_graph(copy.deepcopy(g)))
            sp.cfg = cfg
        rec["clean"] = keys(sp.clean_graph(g))
        if mesh.rank == 0:
            rec["tables"] = tables
        out[name] = rec
    return out


def _dist_nccl_rank(mesh):
    """Part (c): n_shards = 1 over nccl against the plain Pipeline on the
    same card, phase 4's k = 21 case."""
    from faucet_tpu_torch import Config
    from faucet_tpu_torch.dist.sharded import ShardedPipeline
    from faucet_tpu_torch.pipeline import Pipeline

    reads = parity_case()[1]
    cfg = Config(size_kmer=21, max_read_length=100, batch_reads=2048,
                 estimated_kmers=1 << 16, singletons=1 << 17,
                 junction_capacity=1 << 14, sink_capacity=1 << 17,
                 fp_rate=0.002)
    sp = ShardedPipeline(cfg, mesh, counted_metrics())
    gs = sp.run_file_mode(reads, reads)
    p = Pipeline(cfg, counted_metrics(), device=mesh.device)
    g1 = p.run_file_mode(reads, reads)
    keys = lambda g: sorted(g.contigs[i].canonical_seq() for i in g.live())
    slots, content = _same_tables(_np_tables(sp), _single_tables(p))
    return {"backend": mesh.backend, "contigs_equal": keys(gs) == keys(g1),
            "contigs": len(keys(gs)), "slots_equal": slots,
            "content_equal": content, "collectives": dict(mesh.stats)}


def background(tag: str, fn, *a, **kw):
    """Run fn(*a, **kw) in a thread; returns a function that waits for it
    and returns its result, or raises with `tag` if it raised."""
    import threading

    box = {}

    def run():
        try:
            box["value"] = fn(*a, **kw)
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def result():
        t.join()
        if "error" in box:
            raise RuntimeError(f"{tag} failed") from box["error"]
        return box["value"]
    return result


def _spawned_ranks() -> list:
    """Processes started by multiprocessing's spawn (ranks) still alive."""
    ps = subprocess.run(["ps", "-eo", "pid,args"], capture_output=True,
                        text=True, check=True).stdout.splitlines()[1:]
    return [l.strip() for l in ps if "multiprocessing.spawn" in l
            and "spawn_main" in l]


@phase("dist")
def run_dist(parts: str = DIST_PARTS):
    """Hash-range sharding, one process per shard (faucet_tpu_torch/dist).
    The card's machine has one GPU, so the ranks share it over gloo, each
    exchange staged through host memory; NCCL is checked with one rank.
    (a) 2 Mbp at 4 ranks on the card: SCALE_RECORD, genome-true >= 0.99,
        gathered junction and sink tables equal to a single-device run of
        the same configuration on the card; seconds per phase, walk ms per
        step, collectives and routed bytes, Mesh.all_to_all seconds, peak
        memory and launches per rank.
    (b) phase 4's ~50 kbp case at k = 21 and 55, Bloom and exact, the
        phased repeat paired, and --distributed_clean: 4 CPU ranks and 4
        ranks on the card (both run beside (a)) give identical tables and
        contig sets.
    (c) n_shards = 1 over nccl equals the plain Pipeline on the card (run
        beside (a)'s single-device comparison run).
    (d) the CLI, --n_shards 4 on phase 7's 0.5 Mbp reads, two-pass (run
        beside the cli phase's runs when that phase runs): the
        unsharded run's FASTA, and no rank left running.
    (e) B1, B2 and B7 against their plain versions at (a)'s shard shapes
        (its census), as phase 6d."""
    from faucet_tpu_torch.dist.mesh import spawn, usable_cpus

    want = set(parts.split(","))
    rec = report["phases"]["dist"]
    rec["compute_mode"] = _compute_mode()
    S, cards = DIST_SHARDS, ["cuda:0"] * DIST_SHARDS
    shapes = None
    nccl = lambda: spawn(_dist_nccl_rank, 1, devices=["cuda:0"],
                         backend="nccl", timeout=600)
    c_rank = None
    if "b" in want:
        # (b)'s two sets of ranks run beside (a), one core each
        t_b = time.perf_counter()
        b_ranks = {tag: background(
            f"(b) the {tag} ranks", spawn, _dist_parity_rank, S,
            devices=devices, backend="gloo", threads=1, timeout=900)
            for tag, devices in (("cpu", ["cpu"] * S), ("cuda", cards))}
    if "a" in want:
        t0 = time.perf_counter()
        ranks = spawn(_dist_scale_rank, S, devices=cards, backend="gloo",
                      threads=max(1, usable_cpus() // S), timeout=900)
        note(f"dist (a) ranks done in {time.perf_counter() - t0:.1f} s")
        r0 = ranks[0]
        contigs, genome = r0["contigs"], r0["genome"]
        lens = [len(c) for c in contigs]
        got = {"contigs": len(contigs), "n50": n50(lens), "total": sum(lens)}
        frac = genome_true_frac(contigs, genome)
        wst = r0["walk"]
        ms_step = 1e3 * wst["seconds"] / max(wst["steps"], 1)
        per_rank = [r["counts"] for r in ranks]
        counts = {k: sum(c[k] for c in per_rank) for k in per_rank[0]}
        variants = {k: sum(r["variants"].get(k, 0) for r in ranks)
                    for k in ranks[0]["variants"]}
        report["launches_by_path"]["dist"] = counts
        report["cascade_variants_by_path"]["dist"] = variants
        a2a_s = [r["collectives"][p]["all_to_all_s"] for r in ranks
                 for p in ("load", "scan", "graph_build")]
        steps = max(wst["steps"], 1)
        batches = r0["batches"]
        c0 = r0["collectives"]
        per = {"load_per_batch": {k: v / batches for k, v in
                                  c0["load"].items()},
               "scan_per_batch": {k: v / batches for k, v in
                                  c0["scan"].items()},
               "walk_per_step": {k: v / steps for k, v in
                                 c0["graph_build"].items()},
               "walk_route_bytes_per_step": r0["route_bytes"] / steps}
        log(f"(a) {S} ranks on one card: assembly {got}, genome-true "
            f"{frac:.5f}; phases {r0['phase_s']}; walk {wst['steps']} "
            f"steps, {ms_step:.3f} ms/step; peak GiB per rank "
            f"{[round(r['peak_gib'], 3) for r in ranks]}")
        log(f"    rank 0 collectives: {per}")
        log(f"    walk steps, seconds by frontier lanes per rank: "
            f"{wst.get('by_lanes')}")
        log(f"    all_to_all seconds per rank (load+scan+build): "
            f"{[round(sum(a2a_s[i * 3:i * 3 + 3]), 2) for i in range(S)]}")
        log(f"    launches per rank {per_rank}, summed {counts}, cascade "
            f"variants {variants}")
        # (c) runs beside the single-device run of (a)'s configuration on
        # the card (load + scan)
        if "c" in want:
            c_rank = background("(c)", nccl)
        single = _dist_single_tables(r0)
        slots, content = _same_tables(r0["tables"], single)
        log(f"    gathered tables against the single-device run of the "
            f"same configuration: slots identical {slots}, content "
            f"identical {content}")
        rec["a"] = dict(got, genome_true=frac, phase_s=r0["phase_s"],
                        walk=wst, walk_ms_per_step=ms_step,
                        collectives=per, all_to_all_s=a2a_s,
                        peak_gib=[r["peak_gib"] for r in ranks],
                        launches_per_rank=per_rank, launches=counts,
                        tables_slots_equal=slots,
                        tables_content_equal=content,
                        metrics=r0["metrics"],
                        seconds=time.perf_counter() - t0)
        shapes = r0["shapes"]
        if got != SCALE_RECORD:
            raise AssertionError(f"(a) assembly {got} != {SCALE_RECORD}")
        if frac < 0.99:
            raise AssertionError(f"(a) genome-true {frac:.5f} < 0.99")
        # the slot layout may differ where the single device's upsert
        # rounds group a batch's lanes otherwise (tests/dist/
        # test_lossless.py:123); what every consumer reads must not
        if not content:
            raise AssertionError("(a) tables differ from the single-device "
                                 "run's")
        if not all(counts.values()):
            raise AssertionError(f"(a) a kernel was never launched: "
                                 f"{counts}")
    if "b" in want:
        res = {tag: get() for tag, get in b_ranks.items()}
        for name, *_ in _dist_parity_configs():
            a, b = res["cpu"][0][name], res["cuda"][0][name]
            same = all(r[name][x] == b[x] for r in res["cpu"] + res["cuda"]
                       for x in ("raw", "clean") + (("halo",) if "halo" in b
                                                    else ()))
            slots, content = _same_tables(a["tables"], b["tables"])
            log(f"(b) {name}: {len(b['clean'])} contigs, every rank CPU = "
                f"CUDA {same}, tables identical {slots}; CPU {a['s']:.2f} "
                f"s, CUDA {b['s']:.2f} s")
            if not (same and slots and content):
                raise AssertionError(f"(b) {name}: CPU and CUDA differ")
            rec.setdefault("b", {})[name] = {
                "contigs": len(b["clean"]), "cpu_s": a["s"],
                "cuda_s": b["s"]}
        rec["b_seconds"] = time.perf_counter() - t_b  # (a) included
    if "c" in want:
        r = (c_rank or nccl)()[0]
        log(f"(c) n_shards = 1 over {r['backend']}: {r}")
        rec["c"] = r
        if not (r["contigs_equal"] and r["content_equal"]):
            raise AssertionError("(c) nccl run differs from Pipeline")
    if "d" in want:
        rec["d"] = DIST_CLI.get("d") or _dist_cli()
    if "e" in want and shapes is not None:
        run_dist_kernels(shapes)


def _dist_single_tables(r0) -> dict:
    """Junction and sink tables of the single-device Pipeline on the card
    for part (a)'s configuration (load + scan)."""
    import dataclasses

    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    genome, reads = scale_reads()
    cfg = dataclasses.replace(scale_config(len(genome), len(reads)),
                              n_shards=DIST_SHARDS)
    p = Pipeline(cfg, counted_metrics(), device="cuda")
    p.load_batches(batch_iter(reads, cfg))
    p.scan_batches(batch_iter(reads, cfg))
    return _single_tables(p)


def cli_reads():
    """Phase 7's 0.5 Mbp genome and its 30x of 100 bp reads."""
    from faucet_tpu_torch import simulate as SIM

    rng = np.random.default_rng(5)
    genome = SIM.genome_with_repeats(rng, 500_000, n_repeats=4,
                                     repeat_len=400)
    return genome, shred(SIM, rng, genome, False), SIM


def _cli_cmd(fa, prefix, genome, n_reads):
    cfg = scale_config(len(genome), n_reads)
    return [sys.executable, "-m", "faucet_tpu_torch.cli",
            "-read_load_file", fa, "-read_scan_file", fa, "-size_kmer",
            "31", "-max_read_length", "100", "-estimated_kmers",
            str(cfg.estimated_kmers), "-singletons", str(cfg.singletons),
            "--batch_reads", "8192", "-file_prefix", prefix]


def _dist_cli() -> dict:
    """Part (d) alone (the cli phase did not run it): the CLI at
    --n_shards 4 on the card, phase 7's reads, after the unsharded run
    when the cli phase did not run either."""
    genome, reads, SIM = cli_reads()
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "reads.fa")
        SIM.write_fasta(fa, reads)
        if "fasta" not in CLI_TWO_PASS:
            r = subprocess.run(_cli_cmd(fa, os.path.join(d, "one"), genome,
                                        len(reads)), cwd=ROOT,
                               capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise RuntimeError("(d) unsharded cli failed:\n"
                                   + r.stderr[-3000:])
            CLI_TWO_PASS["fasta"] = open(os.path.join(d, "one.fasta"),
                                         "rb").read()
        res, left = run_together({"sharded": (
            _cli_cmd(fa, os.path.join(d, "sharded"), genome, len(reads))
            + ["--n_shards", str(DIST_SHARDS)], None, {})}, d, timeout=900)
        rc, _, err, secs = res["sharded"]
        if rc:
            raise RuntimeError(f"(d) sharded cli failed ({rc}):\n"
                               + err[-3000:])
        return _dist_cli_check(open(os.path.join(d, "sharded.fasta"),
                                    "rb").read(), secs, left)


def _dist_cli_check(got: bytes, secs: float, left: list) -> dict:
    """Part (d)'s FASTA: the unsharded run's contig set (orientation
    aside) and the reference's sharded FASTA bytes; no rank left
    running once the CLI exited."""
    import hashlib

    from faucet_tpu_torch.core.kmer import revcomp_seq

    canon = lambda fasta: sorted(min(s, revcomp_seq(s)) for s in (
        "".join(r.split("\n")[1:]) for r in fasta.decode().split(">")[1:]))
    same_set = canon(got) == canon(CLI_TWO_PASS["fasta"])
    digest = hashlib.sha256(got).hexdigest()
    log(f"(d) cli --n_shards {DIST_SHARDS}: {secs:.2f} s; contig set "
        f"equal to the unsharded run's {same_set}, bytes equal to it "
        f"{got == CLI_TWO_PASS['fasta']}, to the reference's sharded "
        f"FASTA {digest == CLI_SHARDED_FASTA_SHA256}; ranks left "
        f"running {len(left)}")
    if not same_set or digest != CLI_SHARDED_FASTA_SHA256:
        raise AssertionError("(d) sharded CLI FASTA differs")
    if left:
        raise AssertionError(f"(d) ranks left running: {left}")
    return {"seconds": secs, "contig_set_equal": same_set,
            "sha256": digest}


@phase("dist_kernels")
def run_dist_kernels(shapes):
    """B1, B2 and B7 against their plain versions at part (a)'s shard
    shapes and live shares (one rank's census of its load and scan): the
    owner's received window and node probes, its load insert into its
    filter slices, its scan grid's compaction."""
    import torch

    from faucet_tpu_torch.kernels import build as KB

    lib = KB.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    report["dist_shapes"] = shapes
    res = check_probe(gen, dev, lib, [
        (tuple(shape), tuple(shape), round(share, 4))
        for shape, share in shapes["probe"]], prefix="probe_dist_")
    ins = shapes["insert"]
    tag = (f"dist shard dense 2**{ins['la']}/2**{ins['lb']} bits, "
           f"n_hash {ins['nha']}/{ins['nhb']}")
    res["cascade_dist"] = _cascade_case(
        dev, lib, tag, ins["la"], ins["lb"], ins["nha"], ins["nhb"],
        _pool_batches(gen, dev, ins["n"], round(ins["live"], 4)))
    cp = shapes["compact"]
    res.update(check_compact(gen, dev, lib, [
        (cp["n"], round(cp[x], 4), cp["cap"]) for x in ("junction", "sink")],
        prefix="compact_dist_", epoch_run=False))
    report.setdefault("kernels", {}).update(res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also run one load batch, one walk round and 4 "
                         "stream batches under torch.profiler (device busy "
                         "share, launches per walk step)")
    ap.add_argument("--dist_parts", default=DIST_PARTS,
                    help="the dist phase's parts to run (a-e)")
    ap.add_argument("--root", default=REPO,
                    help="import faucet_tpu_torch from this checkout "
                         "instead (to compare two trees in one run; their "
                         "phases 4-8 share the API; a tree whose kernels "
                         "count launches in module globals reports no "
                         "launch counts)")
    args = ap.parse_args(argv)
    want = args.phases.split(",")
    global ROOT
    ROOT = os.path.abspath(args.root)
    sys.path.insert(0, ROOT)
    t_all = time.perf_counter()

    smi = run_device()
    if "build" in want:
        run_build()
    if "kernels" in want:
        run_kernels()
    if "entries" in want:
        run_entries()
    if "parity" in want:
        run_parity()

    # each path's launches: counted from just before it to just after it
    # (the stream phase reads its own after its first, counted run)
    by_path = report["launches_by_path"]
    by_variant = report["cascade_variants_by_path"]

    def counted(path, fn, *a):
        zero_counts()
        r = fn(*a)
        by_path[path], by_variant[path] = read_counts(), read_variants()
        return r

    pass1, reused = None, False
    if "scale" in want:
        pass1 = counted("scale", run_scale, args.profile)
    # the wide phase runs beside the paired phase, in a process of its own
    # with its own counts
    wide = None
    if "wide" in want and "paired" in want:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        apart = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
        wide = apart.submit(_wide_apart, ROOT, args.profile, T_START)
    if "paired" in want:
        counted("paired", run_paired)
    if wide is not None:
        with apart:
            report["phases"]["wide"], by_path["wide"], by_variant["wide"] = \
                wide.result(timeout=900)
    elif "wide" in want:
        counted("wide", run_wide, args.profile)
    if "dualk" in want:
        reused = pass1 is not None
        shapes = counted("dualk", run_dualk, pass1)
        pass1 = None  # frees phase 5's reads
        if "kernels" in want:
            run_dualk_kernels(shapes)
    if "cli" in want:
        # part (d) of the dist phase runs beside the CLI runs
        run_cli("dist" in want and "d" in args.dist_parts.split(","))
    if "stream" in want:
        run_stream(profile=args.profile)
    if "dist" in want:
        # launches counted in each rank, from just before its run to just
        # after, and summed over the ranks
        run_dist(args.dist_parts)
    log(f"[counters] main-path launches by path: {by_path}")
    if "counters" in want:
        launch_census()
        for path, counts in by_path.items():
            # exact mode takes no Bloom kernel: its cascade is two tables
            want_on = ({"compact", "upsert"} & set(counts)
                       if path == "exact" else set(counts))
            if any(bool(n) != (name in want_on)
                   for name, n in counts.items()):
                raise AssertionError(f"{path}: launches {counts}, expected "
                                     f"{sorted(want_on)} and no other")
    # this slice's path is the dual-k one: its k = 31 pass is phase 5's
    # run when phase 6c reused that graph, else phase 6c ran both passes.
    # Scatter-OR has no caller on any path: its entry points were driven,
    # and counted, in phase 3b
    passes = (["scale", "dualk"] if reused
              else ["dualk"] if "dualk" in by_path else [])
    origin = ("the dual-k path: its k = 31 pass in phase 5's window, its "
              "k = 55 pass in phase 6c's" if len(passes) == 2 else
              "the dual-k path: both passes in phase 6c's window")
    launches = {x: sum(by_path[p][x] for p in passes)
                for x in by_path.get("dualk", {})}
    variants = {x: sum(by_variant[p].get(x, 0) for p in passes)
                for x in by_variant.get("dualk", {})}
    if "dist" in by_path:
        # this slice's path: the sharded 2 Mbp run, summed over its ranks
        passes = ["dist"]
        origin = (f"the dist path: {DIST_SHARDS} ranks on one card "
                  "(dist phase (a)), summed over the ranks")
        launches = dict(by_path["dist"])
        variants = dict(by_variant["dist"])
    launches.update(report.get("entry_launches", {}))
    log(f"[counters] dual-k path with the entry points: {launches}; "
        f"cascade launches by the reference's variant: {variants}")
    if "counters" in want and "entries" in want and (
            "dualk" in want or "dist" in want):
        if not all(launches.values()):
            raise AssertionError(f"a kernel was never launched: {launches}")
        # the k = 31 pass runs nodes mode (sparse node-endpoint inserts);
        # only filters over one tile (the wide path's) take multi-tile
        multi = by_variant.get("wide", {}).get("multi_tile", 1)
        if variants and not (variants["dense"] and variants["sparse"]
                             and not variants["multi_tile"] and multi):
            raise AssertionError(f"cascade variants: dual-k {variants}, "
                                 f"wide multi-tile {multi}")

    import torch

    report["launches"] = launches
    report["cascade_variants"] = variants
    report["seconds"] = time.perf_counter() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"total {report['seconds']:.1f} s")
    print(smi)
    print(json.dumps(kernel_line(launches, variants, origin)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
