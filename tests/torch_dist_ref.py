"""Test-side helpers of the tests/test_torch_dist_*.py files: the
reference's sharded pipeline on a CPU mesh, the port's single-device
pipeline, and the comparisons of their global arrays with the ranks'.
"""
import numpy as np
import pytest

from faucet_tpu.config import Config as JConfig
from faucet_tpu.dist import sharded as JSH
from faucet_tpu.dist.mesh import make_mesh
from faucet_tpu_torch.config import Config as TConfig
from faucet_tpu_torch.dist.mesh import spawn
from faucet_tpu_torch.pipeline import Pipeline as TPipeline

import torch_dist_ranks as DR

S = 4
FLAGS = ["-size_kmer", "21", "-max_read_length", "100",
         "-estimated_kmers", "16384", "-singletons", "16384",
         "-fp_rate", "0.002", "--no_native"]


def cli_inputs(d):
    """repeats2024's reads as d/reads.fa, and its two hosts' halves
    (blocks of 64 reads dealt in turn) as d/half0.fa, d/half1.fa."""
    from faucet_tpu_torch import simulate

    reads = DR.reads_of("repeats2024")
    simulate.write_fasta(str(d / "reads.fa"), reads)
    for h in range(2):
        simulate.write_fasta(str(d / f"half{h}.fa"),
                             DR.host_half(reads, h, block=64))
    return d


def _io(d, prefix, fa="reads.fa"):
    return ["-read_load_file", str(d / fa), "-read_scan_file", str(d / fa),
            "-file_prefix", str(d / prefix)]


def ref_tables(sp):
    """The reference pipeline's global arrays as numpy, in the layout of
    torch_dist_ranks.np_table / np_cascade."""
    tab = lambda t: {"hi": np.asarray(t.keys_hi), "lo": np.asarray(t.keys_lo),
                     "vals": [np.asarray(v) for v in t.vals]}
    casc = lambda c: None if c is None else {
        "a": np.asarray(c.a_bloom.words), "b": np.asarray(c.b_bloom.words),
        "at": tab(c.a_table), "bt": tab(c.b_table)}
    return {"cascade": casc(sp.cascade),
            "node": casc(getattr(sp, "node_cascade", None)),
            "junctions": tab(sp.junctions), "sinks": tab(sp.sinks),
            "pairs": tab(sp.pairs)}


def content(t):
    """key -> values of a table's occupied rows (slot placement aside)."""
    occ = t["hi"] != np.uint32(0xFFFFFFFF)
    return {(int(h), int(l)): tuple(np.asarray(v[i]).astype(np.int64)
                                    .tolist() for v in t["vals"])
            for i, h, l in zip(np.nonzero(occ)[0], t["hi"][occ],
                               t["lo"][occ])}


def assert_tables_equal(got, want, slots=True):
    if not slots:
        assert content(got) == content(want)
        return
    np.testing.assert_array_equal(got["hi"], want["hi"])
    np.testing.assert_array_equal(got["lo"], want["lo"])
    assert len(got["vals"]) == len(want["vals"])
    for g, w in zip(got["vals"], want["vals"]):
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64))


def assert_state_equal(got, want, slots=True):
    for name in ("junctions", "sinks", "pairs"):
        assert_tables_equal(got[name], want[name], slots)
    for name in ("cascade", "node"):
        g, w = got[name], want[name]
        assert (g is None) == (w is None), name
        if g is None:
            continue
        np.testing.assert_array_equal(g["a"], w["a"])
        np.testing.assert_array_equal(g["b"], w["b"])
        assert_tables_equal(g["at"], w["at"], slots)
        assert_tables_equal(g["bt"], w["bt"], slots)


def keys(g):
    return sorted(g.contigs[i].canonical_seq() for i in g.live())


def run_ref(inp, cfg_kw, paired=False, cap_factor=None, clean=True,
            monkeypatch=None):
    """The reference's ShardedPipeline on make_mesh(S), same inputs (the
    port's copy of simulate.py makes the reference's reads)."""
    reads = DR.reads_of(inp)
    cfg = JConfig(**{**DR.BASE, **cfg_kw})
    if cap_factor is not None:
        monkeypatch.setattr(JSH, "_cap_for",
                            lambda n, n_shards, factor=2.0: max(
                                32, n // n_shards // cap_factor))
    try:
        sp = JSH.ShardedPipeline(cfg, make_mesh(S))
        sp.load_reads(reads)
        (sp.scan_paired if paired else sp.scan_reads)(reads)
        pc = sp.pair_counts() if paired else None
        g = sp.build()
        out = {"raw": keys(g), "pair_counts": pc,
               "metrics": dict(sp.metrics.counters), **ref_tables(sp)}
        if clean:
            out["clean"] = keys(sp.clean_graph(g))
    finally:
        if cap_factor is not None:
            monkeypatch.undo()
    return out


def run_single(inp, cfg_kw, paired=False, clean=True, **_):
    """The port's single-device Pipeline (owner-prefixed global layout)."""
    reads = DR.reads_of(inp)
    p = TPipeline(TConfig(**{**DR.BASE, **cfg_kw}), device="cpu")
    p.load_reads(reads)
    (p.scan_paired if paired else p.scan_reads)(reads)
    p.flush_junctions()
    pc = p.pair_counts() if paired else None
    g = p.build()
    out = {"raw": keys(g), "pair_counts": pc,
           "cascade": DR.np_cascade(p.cascade),
           "node": DR.np_cascade(p.node_cascade),
           "junctions": DR.np_table(p.junctions),
           "sinks": DR.np_table(p.sinks), "pairs": DR.np_table(p.pairs)}
    if clean:
        out["clean"] = keys(p.clean_graph(g))
    return out


def run_all(cases):
    """(port's ranks, reference, single device) results per case; the
    ranks run on a thread while this process computes the others."""
    mp = pytest.MonkeyPatch()
    join = DR.in_background(spawn, DR.run_cases, S, args=(cases,),
                            threads=1, timeout=400)
    ref = {n: run_ref(monkeypatch=mp, **kw) for n, kw in cases}
    single = {n: run_single(**kw) for n, kw in cases}
    ranks = join()
    return ranks, ref, single
