#!/usr/bin/env python3
"""Sizing sweep of an assembly cell: one whole assembly of the cell's
configuration at each genome length and seed given, after one warm-up,
with its phase seconds and its walk's rounds and steps (each round closed
by a synchronize); one JSON line per assembly on standard output.

    python3 benchmark/sweep.py --workload ecoli-k31.assemble \
        --seeds 11 --mbp 0.5,1,2

The cell's genome length is the largest at which one assembly takes at
most a third of the window (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run, trace  # noqa: E402


def main() -> int:
    from faucet_tpu_torch.graph import walk as W

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mbp", default="0.5,1,2")
    args = ap.parse_args()
    warm = True
    for mbp in map(float, args.mbp.split(",")):
        for seed in map(int, args.seeds.split(",")):
            spec = run.load_spec(args.workload)
            spec["config"]["genome_len"] = int(mbp * 1e6)
            cell = run.Assemble(spec, seed, "cuda")
            if warm:
                cell.warm()
                warm = False
            walk = {}
            name = "walk_round_wide" if cell.pcfg.wide else "walk_round"
            orig = trace.walk_timer(W, name, walk)
            try:
                t0 = time.perf_counter()
                p, contigs = cell.assemble()
                secs = time.perf_counter() - t0
            finally:
                setattr(W, name, orig)
            print(json.dumps({"mbp": mbp, "seed": seed, "assembly_s": secs,
                              "phases_s": p.metrics.timers, "walk": walk,
                              "batches": cell.n_batches,
                              "contigs": len(contigs),
                              "bases": sum(map(len, contigs))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
