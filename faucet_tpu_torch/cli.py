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
writes a torch.profiler Chrome trace into `{file_prefix}.trace/`. The
flags of sharding (`--n_shards > 1`, `--distributed_clean`,
`--coordinator`) exit non-zero naming ROADMAP.md's dist/ item.
Checkpoints are interchangeable with faucet_tpu's.
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
                   help="only 1 is ported (ROADMAP.md: dist/)")
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler Chrome trace into "
                        "{file_prefix}.trace/")
    p.add_argument("--min_contig_cov", type=float, default=2.5)
    p.add_argument("--tip_len_factor", type=float, default=2.0)
    p.add_argument("--distributed_clean", action="store_true",
                   help="not ported (ROADMAP.md: dist/)")
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
    p.add_argument("--coordinator", default=None,
                   help="not ported (ROADMAP.md: dist/)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def unported_flags(a):
    """(flag, ROADMAP item) for every requested feature not ported."""
    out = []
    if a.n_shards > 1:
        out.append(("--n_shards > 1", "dist/"))
    if a.distributed_clean:
        out.append(("--distributed_clean", "dist/"))
    if a.coordinator:
        out.append(("--coordinator", "dist/"))
    return out


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
        tip_len_factor=a.tip_len_factor, junction_detect=a.junction_detect)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bad = unported_flags(args)
    if bad:
        for flag, item in bad:
            print(f"error: {flag} is not ported to faucet_tpu_torch; see "
                  f"ROADMAP.md ({item})", file=sys.stderr)
        return 2
    cfg = config_from_args(args)

    # imports deferred: --help must not pay torch startup
    from faucet_tpu_torch.pipeline import Pipeline

    metrics = Metrics(cfg.metrics_file)
    pipe = Pipeline(cfg, metrics, device=args.device)
    prof = _start_profiler(pipe.device) if cfg.profile else None
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

    resumed = False
    if cfg.bloom_file and cfg.junctions_file:
        pipe.cascade, node_cascade = CK.load_bloom(cfg.bloom_file, cfg,
                                                   pipe.device)
        pipe.node_cascade = node_cascade
        pipe.junctions, pipe.sinks, pairs = CK.load_junctions(
            cfg.junctions_file, cfg, pipe.device)
        if pairs is not None:
            pipe.pairs = pairs
        resumed = True
        print(f"[faucet_tpu_torch] resumed from {cfg.bloom_file} + "
              f"{cfg.junctions_file}", file=sys.stderr)
    elif cfg.bloom_file or cfg.junctions_file:
        print("error: resume needs both -bloom_file and -junctions_file",
              file=sys.stderr)
        return 2

    use_native = not args.no_native
    if use_native:
        from faucet_tpu_torch.io import native as NV

        use_native = NV.available()
        if use_native:
            print("[faucet_tpu_torch] using native C++ reader",
                  file=sys.stderr)
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
        print(f"[faucet_tpu_torch] dual-k on a pipe: spooled load reads "
              f"to {spool}", file=sys.stderr)
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
            CK.save_bloom(f"{cfg.file_prefix}.bloom.npz", cfg, pipe.cascade,
                          pipe.node_cascade)
            CK.save_junctions(f"{cfg.file_prefix}.junctions.npz", cfg,
                              pipe.junctions, pipe.sinks,
                              pipe.pairs if cfg.paired_ends else None)
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
    write_contigs(g, f"{cfg.file_prefix}.fasta")
    write_gfa(g, f"{cfg.file_prefix}.gfa")
    print(f"[faucet_tpu_torch] wrote {cfg.file_prefix}.fasta, "
          f"{cfg.file_prefix}.gfa", file=sys.stderr)
    return 0


def _second_pass(k2: int, cfg, pipe, g, read_batches):
    """Dual-k: reassemble the load reads and the first pass's contigs,
    chunked to read length, at k2; returns the cleaned k2 graph.

    As in the reference, the second pass scans unpaired even in a
    --paired_ends run, so its graph is cleaned with an empty pair table
    (ROADMAP.md C2)."""
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter, contig_chunks

    cfg2 = dataclasses.replace(cfg, size_kmer=k2,
                               file_prefix=cfg.file_prefix + f".k{k2}")
    pipe2 = Pipeline(cfg2, Metrics(cfg.metrics_file), device=pipe.device)
    chunks = contig_chunks(g, cfg.max_read_length, k2)
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
    pipe2.metrics.emit("dual_k_done", stats=g2.stats())
    return g2


if __name__ == "__main__":
    sys.exit(main())
