"""Command-line driver (port of faucet_tpu/cli.py), same flags.

  python -m faucet_tpu_torch.cli -read_load_file reads.fa \
      -read_scan_file reads.fa -size_kmer 31 -estimated_kmers 5000000 \
      -singletons 5000000 -file_prefix out
  python -m faucet_tpu_torch.cli -bloom_file out.bloom.npz \
      -junctions_file out.junctions.npz -size_kmer 31 -file_prefix out2

`--platform` becomes `--device` (default cuda). A run that asks for cuda
where there is none fails; it never falls back to the CPU. Flags of
features that are not ported exit non-zero naming their ROADMAP.md item.
Checkpoints are interchangeable with faucet_tpu's.
"""
from __future__ import annotations

import argparse
import os
import sys

from faucet_tpu.config import Config
from faucet_tpu.metrics import Metrics


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
                   help="not ported (ROADMAP.md: paired ends)")
    p.add_argument("--no_cleaning", action="store_true")
    p.add_argument("--two_hash", action="store_true")
    # ---- extras ----------------------------------------------------------
    p.add_argument("--exact", action="store_true",
                   help="not ported (ROADMAP.md: exact mode)")
    p.add_argument("--stream", action="store_true",
                   help="single-pass mode: insert+scan each batch "
                        "(read_scan_file ignored)")
    p.add_argument("--batch_reads", type=int, default=4096)
    p.add_argument("--n_shards", type=int, default=1,
                   help="only 1 is ported (ROADMAP.md: dist/)")
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--profile", action="store_true",
                   help="not ported (ROADMAP.md)")
    p.add_argument("--min_contig_cov", type=float, default=2.5)
    p.add_argument("--tip_len_factor", type=float, default=2.0)
    p.add_argument("--distributed_clean", action="store_true",
                   help="not ported (ROADMAP.md: dist/)")
    p.add_argument("--junction_detect", default="auto",
                   choices=("auto", "nodes", "ext8"),
                   help="ext8 is not ported (ROADMAP.md: ext8)")
    p.add_argument("-second_kmer", type=int, default=None,
                   help="not ported (ROADMAP.md: dual-k)")
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
    if a.paired_ends:
        out.append(("--paired_ends", "paired ends"))
    if a.exact:
        out.append(("--exact", "exact mode"))
    if a.junction_detect == "ext8":
        out.append(("--junction_detect ext8", "ext8"))
    if a.size_kmer > 31:
        out.append(("-size_kmer > 31", "wide k"))
    if a.n_shards > 1:
        out.append(("--n_shards > 1", "dist/"))
    if a.distributed_clean:
        out.append(("--distributed_clean", "dist/"))
    if a.second_kmer is not None:
        out.append(("-second_kmer", "dual-k"))
    if a.coordinator:
        out.append(("--coordinator", "dist/"))
    if a.profile:
        out.append(("--profile", "profiling"))
    return out


def config_from_args(a) -> Config:
    return Config(
        read_load_file=a.read_load_file, read_scan_file=a.read_scan_file,
        size_kmer=a.size_kmer, max_read_length=a.max_read_length,
        estimated_kmers=a.estimated_kmers, singletons=a.singletons,
        file_prefix=a.file_prefix, fastq=a.fastq,
        no_cleaning=a.no_cleaning, bloom_file=a.bloom_file,
        junctions_file=a.junctions_file, fp_rate=a.fp_rate,
        two_hash=a.two_hash, batch_reads=a.batch_reads,
        metrics_file=a.metrics_file, min_contig_cov=a.min_contig_cov,
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
    from faucet_tpu.io.fastq import read_seqs
    from faucet_tpu_torch.ckpt import state as CK
    from faucet_tpu_torch.out.fasta import write_contigs
    from faucet_tpu_torch.out.gfa import write_gfa
    from faucet_tpu_torch.pipeline import Pipeline, batch_iter

    metrics = Metrics(cfg.metrics_file)
    pipe = Pipeline(cfg, metrics, device=args.device)

    resumed = False
    if cfg.bloom_file and cfg.junctions_file:
        pipe.cascade, node_cascade = CK.load_bloom(cfg.bloom_file, cfg,
                                                   pipe.device)
        pipe.node_cascade = node_cascade
        pipe.junctions, pipe.sinks = CK.load_junctions(
            cfg.junctions_file, cfg, pipe.device)
        resumed = True
        print(f"[faucet_tpu_torch] resumed from {cfg.bloom_file} + "
              f"{cfg.junctions_file}", file=sys.stderr)
    elif cfg.bloom_file or cfg.junctions_file:
        print("error: resume needs both -bloom_file and -junctions_file",
              file=sys.stderr)
        return 2

    use_native = not args.no_native
    if use_native:
        from faucet_tpu.io import native as NV

        use_native = NV.available()
        if use_native:
            print("[faucet_tpu_torch] using native C++ reader",
                  file=sys.stderr)

    def batches_of(path):
        if use_native:
            from faucet_tpu.io import native as NV

            return NV.native_batch_iter(path, cfg.fastq, cfg.batch_reads,
                                        cfg.max_read_length)
        return batch_iter(read_seqs(path, cfg.fastq), cfg)

    for f in (cfg.read_load_file, cfg.read_scan_file):
        if f and f != "-" and not os.path.exists(f):
            print(f"error: input file not found: {f}", file=sys.stderr)
            return 2

    if not resumed:
        if args.stream:
            if not cfg.read_load_file:
                print("error: --stream needs -read_load_file",
                      file=sys.stderr)
                return 2
            g = pipe.run_streaming_batches(batches_of(cfg.read_load_file))
        else:
            if not (cfg.read_load_file and cfg.read_scan_file):
                print("error: need -read_load_file and -read_scan_file "
                      "(or --stream, or -bloom_file/-junctions_file)",
                      file=sys.stderr)
                return 2
            pipe.load_batches(batches_of(cfg.read_load_file))
            pipe.scan_batches(batches_of(cfg.read_scan_file))
        CK.save_bloom(f"{cfg.file_prefix}.bloom.npz", cfg, pipe.cascade,
                      pipe.node_cascade)
        CK.save_junctions(f"{cfg.file_prefix}.junctions.npz", cfg,
                          pipe.junctions, pipe.sinks)
        if not args.stream:  # run_streaming built+cleaned already
            g = pipe._finish()
    else:
        g = pipe._finish()

    write_contigs(g, f"{cfg.file_prefix}.fasta")
    write_gfa(g, f"{cfg.file_prefix}.gfa")
    print(f"[faucet_tpu_torch] wrote {cfg.file_prefix}.fasta, "
          f"{cfg.file_prefix}.gfa", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
