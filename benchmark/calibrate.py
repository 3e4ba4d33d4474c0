#!/usr/bin/env python3
"""Readings that the limits of benchmark/check.py are set from, at a
cell's own size on the card, several seeds in one process.

    python3 benchmark/calibrate.py --workload saureus-k55.ingest \
        --seeds 11,12,13 [--faults 3]

A run of the benchmark draws its genome and reads from the
configuration's data_seed (benchmark/gen.py); here each seed draws its own
genome and reads, so that the readings span genomes. For each seed: one
dataset (or one assembly) through the program, as a run's window drives
it, then the numbers compared for the program (the sound reading). For
the first --faults seeds, also for what is put in the program's place:
the control (the reference with one hash fewer per filter, which breaks
the configuration's false-positive guarantee), a state left unchanged
(the filters and tables as created), half of each batch left out (the
reference over the other half), and an answer altered where it is
produced (one junction record's coverage; in an assembly, one base of
the longest contig, each contig split in two at its middle as a walk
that stops early leaves it, and each contig's last two bases dropped). One
JSON line per seed and reading. The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import check, gen, run  # noqa: E402


def _as_program(ref) -> dict:
    t = ref.tables()
    return {"filters": ref.filter_words(), "junctions": t["junctions"],
            "sinks": t["sinks"]}


def _empty_like(prog: dict) -> dict:
    import torch

    z = lambda rows: (rows[0][:0], [v[:0] for v in rows[1]])
    return {"filters": {n: torch.zeros_like(w)
                        for n, w in prog["filters"].items()},
            "junctions": z(prog["junctions"]), "sinks": z(prog["sinks"])}


def _altered(prog: dict) -> dict:
    keys, vals = prog["junctions"]
    vals = [v.clone() for v in vals]
    vals[0][0] += 1
    return dict(prog, junctions=(keys, vals))


def _contig_altered(contigs):
    c = max(contigs, key=len)
    i = len(c) // 2
    c2 = c[:i] + ("A" if c[i] != "A" else "C") + c[i + 1:]
    return [c2 if x is c else x for x in contigs]


def _contigs_split(contigs, k: int):
    """Each contig of 2k bases or more in two halves that overlap by
    k - 1 bases: every k-mer kept, every piece genome-true."""
    out = []
    for c in contigs:
        m = len(c) // 2
        out += [c[:m + k - 1], c[m:]] if len(c) >= 2 * k else [c]
    return out


def _contigs_truncated(contigs):
    """Each contig without its last two bases. A contig's last k-mer is
    the junction node that the next contig starts with, so the k-mer
    before it, which no other contig holds, is what goes missing."""
    return [c[:-2] for c in contigs]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=0,
                    help="read the control and the faults on this many of "
                    "the first seeds")
    args = ap.parse_args()
    for n, seed in enumerate(map(int, args.seeds.split(","))):
        spec = run.load_spec(args.workload)
        spec["config"]["data_seed"] = seed
        cell = run.DRIVERS[spec["workload"]["passes"]](spec, seed, "cuda")
        if n == 0:
            cell.warm()
        cell.window(0.01, False)
        prog = cell.state()
        cell.last = None
        gc.collect()
        torch.cuda.empty_cache()
        ref = cell.reference()
        out = lambda what, nums: print(json.dumps(
            {"cell": args.workload, "seed": seed, "reading": what,
             "numbers": nums, "correct": check.verdict(nums)}), flush=True)
        out("program", run.check_numbers(cell, prog, ref))
        if n >= args.faults:
            continue
        out("control", check.state_numbers(
            _as_program(cell.reference(hash_delta=-1)), ref))
        out("unchanged_state", check.state_numbers(_empty_like(prog), ref))
        half = slice(0, cell.B // 2)
        out("half_batch", check.state_numbers(
            _as_program(cell.reference(rows=half)), ref))
        out("altered_cov", check.state_numbers(_altered(prog), ref))
        if getattr(cell, "contigs", None):
            contigs = cell.contigs[-1]
            chunk = gen.chunk_len(spec["config"])
            for what, cs in (("altered_contig", _contig_altered(contigs)),
                             ("split_contigs",
                              _contigs_split(contigs, cell.k)),
                             ("truncated_contigs",
                              _contigs_truncated(contigs))):
                out(what, check.contig_numbers(cs, cell.genome, cell.k,
                                               chunk))
    return 0


if __name__ == "__main__":
    sys.exit(main())
