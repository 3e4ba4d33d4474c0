"""Command-line driver (port of faucet_tpu/cli.py), same flags.

  python -m faucet_tpu_torch.cli -read_load_file reads.fa \
      -read_scan_file reads.fa -size_kmer 31 -estimated_kmers 5000000 \
      -singletons 5000000 -file_prefix out
  python -m faucet_tpu_torch.cli -bloom_file out.bloom.npz \
      -junctions_file out.junctions.npz -size_kmer 31 -file_prefix out2

  cat reads.fa | python -m faucet_tpu_torch.cli -read_load_file - \
      -read_scan_file reads.fa -size_kmer 31 -second_kmer 55 --profile

`--platform` becomes `--device` (default cuda). A run that asks for cuda
where there is none fails; it never falls back to the CPU. `--profile`
writes a torch.profiler Chrome trace into `{file_prefix}.trace/`.
Checkpoints are interchangeable with faucet_tpu's.

Sharding: `--n_shards N` (N > 1) starts N ranks, one process per shard
(dist/mesh.py spawn); rank r runs on cuda:(r % device_count), or on the
CPU with `--device cpu`. The backend is nccl when every rank has a GPU of
its own and gloo when ranks share one (or run on the CPU). Multi-host:
`--coordinator host:port --num_processes P --process_id p` on each host
starts that host's N / P ranks (global ranks p * N/P + i) and joins them
to the others through `init_process_group("tcp://host:port")`; each host
feeds its own reads. Every rank builds and cleans the same graph; global
rank 0 alone writes the FASTA, GFA, checkpoints (gathered global arrays)
and metrics. Reads from stdin or a FIFO are spooled to a temporary file
first, which every rank then reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import stat
import sys
import tempfile

from faucet_tpu_torch.config import Config
from faucet_tpu_torch.metrics import Metrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="faucet_tpu_torch",
        description="streaming de Bruijn assembler (faucet_tpu's main path "
                    "in PyTorch with CUDA kernels for Hopper)")
    # ---- reference-compatible flags (single dash, same names) ----------
    p.add_argument("-read_load_file", default=None,
                   help="reads for the Bloom cascade load pass ('-'=stdin)")
    p.add_argument("-read_scan_file", default=None,
                   help="reads for the junction scan pass")
    p.add_argument("-size_kmer", type=int, default=31)
    p.add_argument("-max_read_length", type=int, default=256)
    p.add_argument("-estimated_kmers", type=int, default=1 << 22)
    p.add_argument("-singletons", type=int, default=1 << 22)
    p.add_argument("-file_prefix", default="faucet_tpu_out")
    p.add_argument("-fp_rate", type=float, default=0.01)
    p.add_argument("-bloom_file", default=None,
                   help="resume: membership checkpoint (skips load+scan "
                        "when -junctions_file is also given)")
    p.add_argument("-junctions_file", default=None,
                   help="resume: junction/sink checkpoint")
    p.add_argument("--fastq", action="store_true")
    p.add_argument("--paired_ends", action="store_true",
                   help="scan file is interleaved mate pairs; junction "
                        "pairs feed disentanglement")
    p.add_argument("--no_cleaning", action="store_true")
    p.add_argument("--two_hash", action="store_true")
    # ---- extras ----------------------------------------------------------
    p.add_argument("--exact", action="store_true",
                   help="exact-membership mode (golden/debug)")
    p.add_argument("--stream", action="store_true",
                   help="single-pass mode: insert+scan each batch "
                        "(read_scan_file ignored)")
    p.add_argument("--batch_reads", type=int, default=4096)
    p.add_argument("--n_shards", type=int, default=1,
                   help="hash-range shards: one process (rank) each")
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler Chrome trace into "
                        "{file_prefix}.trace/")
    p.add_argument("--min_contig_cov", type=float, default=2.5)
    p.add_argument("--tip_len_factor", type=float, default=2.0)
    p.add_argument("--distributed_clean", action="store_true",
                   help="sharded runs: clean via the halo-exchange "
                        "partitioned cleaner (dist/halo.py) instead of "
                        "the single-host passes")
    p.add_argument("--junction_detect", default="auto",
                   choices=("auto", "nodes", "ext8"),
                   help="auto: nodes for k <= 31, ext8 above")
    p.add_argument("-second_kmer", type=int, default=None,
                   help="dual-k pass (BASELINE.md configuration 2): after "
                        "the -size_kmer assembly, reassemble reads + "
                        "chunked first-pass contigs at this larger k")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--no_native", action="store_true",
                   help="disable the C++ reader/packer (use pure Python)")
    # ---- multi-host: per-host input, ranks joined over TCP -------------
    p.add_argument("--coordinator", default=None,
                   help="multi-host: host:port of the process group's "
                        "store (init_process_group('tcp://host:port'))")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


# sharded runs: seconds a rank may wait at one collective, and the whole
# run's limit (a rank that dies fails the run at once, dist/mesh.py)
DIST_TIMEOUT_S = 86400.0


def config_from_args(a) -> Config:
    return Config(
        read_load_file=a.read_load_file, read_scan_file=a.read_scan_file,
        size_kmer=a.size_kmer, max_read_length=a.max_read_length,
        estimated_kmers=a.estimated_kmers, singletons=a.singletons,
        file_prefix=a.file_prefix, fastq=a.fastq,
        paired_ends=a.paired_ends, no_cleaning=a.no_cleaning,
        bloom_file=a.bloom_file, junctions_file=a.junctions_file,
        fp_rate=a.fp_rate, two_hash=a.two_hash, exact=a.exact,
        batch_reads=a.batch_reads, metrics_file=a.metrics_file,
        profile=a.profile, min_contig_cov=a.min_contig_cov,
        tip_len_factor=a.tip_len_factor, junction_detect=a.junction_detect,
        n_shards=a.n_shards, distributed_clean=a.distributed_clean)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.coordinator or cfg.n_shards > 1:
        return _main_sharded(args, cfg)

    # imports deferred: --help must not pay torch startup
    from faucet_tpu_torch.pipeline import Pipeline

    metrics = Metrics(cfg.metrics_file)
    pipe = Pipeline(cfg, metrics, device=args.device)
    return _profiled(args, cfg, pipe, pipe.device)


def _profiled(args, cfg, pipe, device) -> int:
    prof = _start_profiler(device) if cfg.profile else None
    try:
        rc = _run(args, cfg, pipe)
    finally:
        if prof is not None:
            prof.stop()
    if prof is not None and rc == 0:
        prof_dir = f"{cfg.file_prefix}.trace"
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
        print(f"[faucet_tpu_torch] profile trace in {prof_dir}",
              file=sys.stderr)
    return rc


def _main_sharded(args, cfg) -> int:
    """Start this host's ranks (dist/mesh.py spawn) and return global rank
    0's exit code (on the other hosts, the largest of their ranks')."""
    import torch

    from faucet_tpu_torch.device import resolve_device
    from faucet_tpu_torch.dist.mesh import (default_backend, spawn,
                                            usable_cpus)

    hosts, host = args.num_processes or 1, args.process_id or 0
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        print("error: --coordinator needs --num_processes and "
              "--process_id", file=sys.stderr)
        return 2
    if cfg.n_shards % hosts or not 0 <= host < hosts:
        print(f"error: {cfg.n_shards} shards do not split over "
              f"{hosts} processes (process {host})", file=sys.stderr)
        return 2
    local = cfg.n_shards // hosts
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        n_gpu = torch.cuda.device_count()
        devices = [f"cuda:{(host * local + i) % n_gpu}" for i in range(local)]
    else:
        devices = [str(dev)] * local
    if not args.no_native:
        from faucet_tpu_torch.io import native as NV

        NV.available()  # one build in this process, not one per rank
    spools = {}
    try:
        # a pipe or stdin cannot be read by every rank: spool it once
        for name in ("read_load_file", "read_scan_file"):
            path = getattr(cfg, name)
            if path and _is_pipe(path):
                if path not in spools:
                    spools[path] = _spool(path)
                cfg = dataclasses.replace(cfg, **{name: spools[path]})
        rcs = spawn(_rank_main, cfg.n_shards, args=(args, cfg),
                    devices=devices, backend=default_backend(devices),
                    timeout=DIST_TIMEOUT_S,
                    # the ranks share this process's threads
                    threads=max(1, min(torch.get_num_threads(),
                                       usable_cpus()) // local),
                    init_method=(f"tcp://{args.coordinator}"
                                 if args.coordinator else None),
                    hosts=hosts, host=host)
    finally:
        for f in spools.values():
            os.unlink(f)
    return rcs[0] if host == 0 else max(rcs)


def _rank_main(mesh, args, cfg) -> int:
    """One rank of a sharded CLI run."""
    from faucet_tpu_torch.dist.sharded import ShardedPipeline

    main_rank = mesh.rank == 0
    pipe = ShardedPipeline(cfg, mesh,
                           Metrics(cfg.metrics_file if main_rank else None))
    if main_rank:
        return _profiled(args, cfg, pipe, pipe.device)
    return _run(args, cfg, pipe)


def _start_profiler(device):
    """torch.profiler over the whole run: host activity, plus the card's
    kernels when the run is on CUDA."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _is_pipe(path) -> bool:
    if path == "-":
        return True
    try:
        return stat.S_ISFIFO(os.stat(path).st_mode)
    except OSError:
        return False


def _spool(path) -> str:
    """Copy stdin ('-') or a FIFO to a temporary file; returns its name."""
    spool = tempfile.NamedTemporaryFile(
        prefix="faucet_tpu_torch_spool_", suffix=".reads", delete=False)
    try:
        src = sys.stdin.buffer if path == "-" else open(path, "rb")
        with spool, src:
            shutil.copyfileobj(src, spool)
    except BaseException:
        # a copy cut short (broken pipe, interrupt, full disk) leaves no
        # spool file behind either
        spool.close()
        os.unlink(spool.name)
        raise
    return spool.name


def _run(args, cfg, pipe) -> int:
    from faucet_tpu_torch.io.fastq import read_seqs
    from faucet_tpu_torch.ckpt import state as CK
    from faucet_tpu_torch.out.fasta import write_contigs
    from faucet_tpu_torch.out.gfa import write_gfa
    from faucet_tpu_torch.pipeline import batch_iter

    # a sharded run's ranks all run this; rank 0 alone speaks and writes
    mesh = getattr(pipe, "mesh", None)
    main_rank = mesh is None or mesh.rank == 0
    say = (lambda msg: print(msg, file=sys.stderr)) if main_rank \
        else (lambda msg: None)
    resumed = False
    if cfg.bloom_file and cfg.junctions_file:
        cascade, node_cascade = CK.load_bloom(cfg.bloom_file, cfg,
                                              pipe.device)
        junctions, sinks, pairs = CK.load_junctions(cfg.junctions_file,
                                                    cfg, pipe.device)
        if mesh is not None:
            # each rank keeps its slices of the global arrays
            pipe.place_state(cascade, node_cascade, junctions, sinks, pairs)
        else:
            pipe.cascade, pipe.node_cascade = cascade, node_cascade
            pipe.junctions, pipe.sinks = junctions, sinks
            if pairs is not None:
                pipe.pairs = pairs
        resumed = True
        say(f"[faucet_tpu_torch] resumed from {cfg.bloom_file} + "
            f"{cfg.junctions_file}")
    elif cfg.bloom_file or cfg.junctions_file:
        print("error: resume needs both -bloom_file and -junctions_file",
              file=sys.stderr)
        return 2

    use_native = not args.no_native
    if use_native:
        from faucet_tpu_torch.io import native as NV

        use_native = NV.available()
        if use_native:
            say("[faucet_tpu_torch] using native C++ reader")
    if cfg.paired_ends and cfg.batch_reads % 2:
        print("error: --paired_ends needs an even --batch_reads",
              file=sys.stderr)
        return 2

    def batches_of(path):
        if use_native:
            from faucet_tpu_torch.io import native as NV

            return NV.native_batch_iter(path, cfg.fastq, cfg.batch_reads,
                                        cfg.max_read_length)
        return batch_iter(read_seqs(path, cfg.fastq), cfg)

    for f in (cfg.read_load_file, cfg.read_scan_file):
        if f and f != "-" and not os.path.exists(f):
            print(f"error: input file not found: {f}", file=sys.stderr)
            return 2

    spool = None
    if (args.second_kmer and not resumed and cfg.read_load_file
            and _is_pipe(cfg.read_load_file)):
        # dual-k reads the load reads twice; a pipe or stdin cannot be
        # re-read, so it is spooled to a temporary file first
        spool = _spool(cfg.read_load_file)
        say(f"[faucet_tpu_torch] dual-k on a pipe: spooled load reads "
            f"to {spool}")
        cfg = dataclasses.replace(cfg, read_load_file=spool)

    # the spool file must not outlive the run on any exit path
    try:
        if not resumed:
            if args.stream:
                if not cfg.read_load_file:
                    print("error: --stream needs -read_load_file",
                          file=sys.stderr)
                    return 2
                if use_native:
                    g = pipe.run_streaming_batches(
                        batches_of(cfg.read_load_file))
                else:
                    g = pipe.run_streaming(read_seqs(cfg.read_load_file,
                                                     cfg.fastq))
            else:
                if not (cfg.read_load_file and cfg.read_scan_file):
                    print("error: need -read_load_file and "
                          "-read_scan_file (or --stream, or "
                          "-bloom_file/-junctions_file)", file=sys.stderr)
                    return 2
                pipe.load_batches(batches_of(cfg.read_load_file))
                if not cfg.paired_ends:
                    pipe.scan_batches(batches_of(cfg.read_scan_file))
                elif use_native:
                    pipe.scan_paired_batches(batches_of(cfg.read_scan_file))
                else:
                    pipe.scan_paired(read_seqs(cfg.read_scan_file,
                                               cfg.fastq))
            _save_checkpoints(cfg, pipe, main_rank)
            if not args.stream:  # run_streaming built+cleaned already
                g = pipe._finish()
        else:
            g = pipe._finish()

        if args.second_kmer and not resumed:
            g = _second_pass(args.second_kmer, cfg, pipe, g,
                             lambda: batches_of(cfg.read_load_file))
    finally:
        if spool is not None:
            os.unlink(spool)
    if main_rank:
        write_contigs(g, f"{cfg.file_prefix}.fasta")
        write_gfa(g, f"{cfg.file_prefix}.gfa")
    say(f"[faucet_tpu_torch] wrote {cfg.file_prefix}.fasta, "
        f"{cfg.file_prefix}.gfa")
    return 0


def _save_checkpoints(cfg, pipe, main_rank: bool):
    """The post-scan checkpoints; a sharded run writes the gathered
    global arrays, once."""
    from faucet_tpu_torch.ckpt import state as CK

    if getattr(pipe, "mesh", None) is not None:
        cascade, node_cascade, junctions, sinks, pairs = pipe.global_state()
    else:
        cascade, node_cascade = pipe.cascade, pipe.node_cascade
        junctions, sinks, pairs = pipe.junctions, pipe.sinks, pipe.pairs
    if main_rank:
        CK.save_bloom(f"{cfg.file_prefix}.bloom.npz", cfg, cascade,
                      node_cascade)
        CK.save_junctions(f"{cfg.file_prefix}.junctions.npz", cfg,
                          junctions, sinks,
                          pairs if cfg.paired_ends else None)


def _second_pass(k2: int, cfg, pipe, g, read_batches):
    """Dual-k: reassemble the load reads and the first pass's contigs,
    chunked to read length, at k2; returns the cleaned k2 graph.

    As in the reference, the second pass scans unpaired even in a
    --paired_ends run, so its graph is cleaned with an empty pair table
    (ROADMAP.md C2)."""
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter, contig_chunks

    cfg2 = dataclasses.replace(cfg, size_kmer=k2,
                               file_prefix=cfg.file_prefix + f".k{k2}")
    mesh = getattr(pipe, "mesh", None)
    main_rank = mesh is None or mesh.rank == 0
    metrics = Metrics(cfg.metrics_file if main_rank else None)
    if mesh is not None:  # the second pass runs sharded too
        from faucet_tpu_torch.dist.sharded import ShardedPipeline

        pipe2 = ShardedPipeline(cfg2, mesh, metrics)
    else:
        pipe2 = Pipeline(cfg2, metrics, device=pipe.device)
    chunks = contig_chunks(g, cfg.max_read_length, k2)
    if main_rank:
        print(f"[faucet_tpu_torch] dual-k second pass at k={k2} "
              f"({len(chunks) // 2} contig chunks)", file=sys.stderr)

    def second_batches():
        # the reads as the first pass read them, then the chunks
        yield from read_batches()
        yield from batch_iter(chunks, cfg2)

    pipe2.load_batches(second_batches())
    pipe2.scan_batches(second_batches())
    g2 = pipe2.clean_graph(pipe2.build())
    pipe2.metrics.add("contigs", len(g2.live()))
    if main_rank:
        pipe2.metrics.emit("dual_k_done", stats=g2.stats())
    return g2


if __name__ == "__main__":
    sys.exit(main())
