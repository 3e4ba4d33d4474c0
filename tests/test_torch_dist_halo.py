"""dist/halo.py (the halo-exchange partitioned cleaner, host code copied
from the reference) against faucet_tpu/dist/halo.py on the cases of
tests/dist/test_halo.py, and against the port's sequential clean().

The raw graphs come from the port's single-device pipeline (bit-identical
to the reference's, tests/test_torch_pipeline.py); the reference cleaner
gets the same contigs in its own graph classes. Port and reference must
agree exactly (sequences, circularity, cov and stats); against clean()
sequences and topology are equal and cov within 1% (see halo.py's
docstring). With a mesh, the port transposes the message buffers on the
mesh's device. The last test shows the reference fault the port mirrors
(ROADMAP.md C2): _disentangle_nodes counts a node as resolved although
its merges were refused.
"""
import copy

import numpy as np
import pytest
import torch

from faucet_tpu.dist import halo as JH
from faucet_tpu.graph import model as JM
from faucet_tpu_torch import simulate
from faucet_tpu_torch.config import Config
from faucet_tpu_torch.core import kmer as TK
from faucet_tpu_torch.dist import halo as TH
from faucet_tpu_torch.dist.mesh import Mesh
from faucet_tpu_torch.graph.clean import clean
from faucet_tpu_torch.graph.model import Contig, ContigGraph, End
from faucet_tpu_torch.pipeline import Pipeline

import torch_dist_ranks as DR

torch.set_num_threads(1)

K = 21
N = 8


def to_ref(g):
    """The live contigs of a port graph as a reference ContigGraph."""
    end = lambda e: None if e is None else JM.End(e.node, e.slot)
    return JM.ContigGraph(g.k, [
        JM.Contig(seq=c.seq, cov=c.cov, left=end(c.left),
                  right=end(c.right), circular=c.circular)
        for c in (g.contigs[i] for i in g.live())])


def _sig(g):
    return sorted((c.canonical_seq(), c.circular, c.cov)
                  for i in g.live() for c in [g.contigs[i]])


def _assert_near(a, b):
    """Sequences + topology equal; cov within 1% (merge order)."""
    assert [(s, c) for s, c, _ in a] == [(s, c) for s, c, _ in b]
    for (_, _, ca), (_, _, cb) in zip(a, b):
        assert abs(ca - cb) <= 0.01 * max(ca, cb, 1.0)


def both(g, mesh=None, **kw):
    """(port stats, port signature, reference stats, reference sig)."""
    out = []
    for mod, graph in ((TH, copy.deepcopy(g)), (JH, to_ref(g))):
        pc = mod.PartitionedCleaner(graph, N,
                                    mesh=mesh if mod is TH else None)
        st = pc.clean(**kw)
        out += [st, _sig(pc.result())]
    return out


@pytest.fixture(scope="module")
def raw_graph():
    rng = np.random.default_rng(77)
    genome = simulate.genome_with_repeats(rng, 12_000, n_repeats=3,
                                          repeat_len=250)
    reads = simulate.shred(rng, genome, coverage=35, read_len=90,
                           err_rate=0.006)
    cfg = Config(size_kmer=K, max_read_length=90, batch_reads=512,
                 estimated_kmers=1 << 15, singletons=1 << 17,
                 junction_capacity=1 << 13, sink_capacity=1 << 15,
                 fp_rate=0.01)
    p = Pipeline(cfg, device="cpu")
    p.load_reads(reads)
    p.scan_reads(reads)
    return p.build()


@pytest.mark.parametrize("use_mesh", [False, True])
def test_partitioned_clean_matches_reference(raw_graph, use_mesh):
    g_seq = copy.deepcopy(raw_graph)
    st = clean(g_seq, max_tip_len=180, min_cov=2.5)
    assert st["tips"] + st["low_cov"] + st["isolated"] > 0
    assert st["collapsed"] > 0
    mesh = Mesh(N, 0, "cpu", "gloo") if use_mesh else None
    t_st, t_sig, j_st, j_sig = both(raw_graph, mesh=mesh, max_tip_len=180,
                                    min_cov=2.5)
    assert t_st == j_st and t_sig == j_sig
    _assert_near(t_sig, _sig(g_seq))
    assert t_st["collective_bytes"] > 0 and t_st["rounds"] >= 2
    assert t_st["bubbles"] + t_st["chimeric"] > 0


def test_partitioned_collapse_only_matches(raw_graph):
    g2 = copy.deepcopy(raw_graph)
    clean(g2, max_tip_len=0, min_cov=0.0, do_tips=False, do_low_cov=False)
    t_st, t_sig, j_st, j_sig = both(raw_graph, max_tip_len=0, min_cov=0.0,
                                    do_tips=False, do_low_cov=False)
    assert t_st == j_st and t_sig == j_sig
    _assert_near(t_sig, _sig(g2))


def _planted_eqlen_bubble():
    """tests/dist/test_halo.py's equal-length bubble (weak arm at 0.5x,
    killable only by the EQLEN_RATIO rule)."""
    g = ContigGraph(21)
    X = "ACGTG" * 4 + "A"
    Y = "TTGCA" * 4 + "C"
    for node, s1, s2 in ((X, 5, 6), (Y, 1, 2)):
        g.add_contig(Contig(seq="ACGT" * 150, cov=18.0,
                            right=End(node, s1)))
        g.add_contig(Contig(seq="TGCA" * 150, cov=17.0,
                            right=End(node, s2)))
    g.add_contig(Contig(seq="A" * 80, cov=18.0, left=End(X, 0),
                        right=End(Y, 5)))
    g.add_contig(Contig(seq="C" * 80, cov=9.0, left=End(X, 1),
                        right=End(Y, 6)))
    return g


def test_equal_length_bubble_pops_in_both():
    g_seq = _planted_eqlen_bubble()
    assert clean(g_seq, max_tip_len=0, min_cov=0.0,
                 do_tips=False)["bubbles"] == 1
    t_st, t_sig, j_st, j_sig = both(_planted_eqlen_bubble(), max_tip_len=0,
                                    min_cov=0.0, do_tips=False)
    assert t_st["bubbles"] == 1 and t_st == j_st and t_sig == j_sig
    _assert_near(t_sig, _sig(g_seq))


def _planted_four_copy_repeat():
    """A repeat's contig from node X to node Y (leaving X by its right
    side, entering Y by its left) at 100x, and the four chunks between its
    copies from Y back to X (leaving Y by its right side, entering X by
    its left) at 24x each, under a quarter of the repeat's: no bubble, so
    no arm may go (ROADMAP C3)."""
    g = ContigGraph(21)
    X = "ACGTG" * 4 + "A"
    Y = "TTGCA" * 4 + "C"
    g.add_contig(Contig(seq="G" * 400, cov=100.0, left=End(X, 0),
                        right=End(Y, 5)))
    for i in range(4):
        g.add_contig(Contig(seq="ACGT"[i] * (1000 + 100 * i), cov=24.0,
                            left=End(Y, i), right=End(X, 4 + i)))
    return g


def test_a_four_copy_repeat_keeps_its_chunks_in_both_cleaners():
    """The port's sequential and partitioned cleaners keep all five
    contigs; the reference's, which groups arms by their end nodes alone,
    deletes the four chunks (ROADMAP C2, the port diverges)."""
    g_seq = _planted_four_copy_repeat()
    st = clean(g_seq, max_tip_len=0, min_cov=0.0, do_tips=False)
    assert st["bubbles"] == 0 and len(g_seq.live()) == 5
    t_st, t_sig, j_st, j_sig = both(_planted_four_copy_repeat(),
                                    max_tip_len=0, min_cov=0.0,
                                    do_tips=False)
    assert t_st["bubbles"] == 0 and len(t_sig) == 5
    _assert_near(t_sig, _sig(g_seq))
    assert j_st["bubbles"] == 4 and len(j_sig) == 1


@pytest.mark.parametrize("use_mesh", [False, True])
def test_exchange_fixed_capacity_discipline(use_mesh):
    """Every trip moves the same n*n*CAP*W buffer; rows arrive intact and
    in order, with or without the mesh's device transpose."""
    mesh = Mesh(N, 0, "cpu", "gloo") if use_mesh else None
    ex, jex = TH.Exchange(N, mesh), JH.Exchange(N)
    hot = [(7, i, i * 3) for i in range(2000)]
    out = [[[] for _ in range(N)] for _ in range(N)]
    out[0][1] = list(hot)
    out[3][4] = [(1, 42), (0xFFFFFFFF, 5)]
    inbox = ex.exchange(copy.deepcopy(out))
    assert inbox == jex.exchange(copy.deepcopy(out))
    assert inbox[1][0] == [tuple(list(r) + [0] * (ex.W - len(r)))
                           for r in hot]
    assert inbox[4][3][1][:2] == (0xFFFFFFFF, 5)
    trips = -(-len(hot) // ex.cap)
    assert ex.rounds == jex.rounds == trips
    assert ex.bytes == jex.bytes == trips * (N * N * ex.cap * ex.W * 4
                                             + N * N * 4)


@pytest.fixture(scope="module")
def paired_graph():
    """The phased repeat with pair capture (exact mode), as the
    reference's paired_graph fixture."""
    interleaved = DR.phased_case()[0]
    cfg = Config(size_kmer=K, max_read_length=80, batch_reads=128,
                 exact=True, estimated_kmers=1 << 15, singletons=1 << 15,
                 junction_capacity=1 << 13, sink_capacity=1 << 14,
                 pair_capacity=1 << 14, paired_ends=True)
    pl = Pipeline(cfg, device="cpu")
    pl.load_reads(interleaved)
    pl.scan_paired(interleaved)
    return pl.build(), pl._pair_count_fn()


def test_partitioned_disentangle_matches(paired_graph):
    g0, pc_fn = paired_graph
    assert pc_fn is not None
    g_seq = copy.deepcopy(g0)
    st = clean(g_seq, max_tip_len=160, min_cov=2.5, pair_count=pc_fn,
               min_pairs=2)
    assert st["disentangled"] >= 1
    t_st, t_sig, j_st, j_sig = both(g0, max_tip_len=160, min_cov=2.5,
                                    pair_count=pc_fn, min_pairs=2)
    assert t_st["disentangled"] >= 1
    assert t_st == j_st and t_sig == j_sig
    _assert_near(t_sig, _sig(g_seq))


def _planted_repeat_node():
    """A 2-in/2-out node X whose four contigs run to distinct far nodes,
    and pair evidence A-C, B-D across it: the case _disentangle_nodes
    resolves with two merges."""
    node = lambda s: (s * 21)[:21]
    X, A, B, C, D = (node(s) for s in ("ACGGT", "AAGCT", "ACCTG", "AGTCC",
                                       "ATGGC"))
    g = ContigGraph(21)
    for far, slot, seq in ((A, 0, "A" * 60), (B, 1, "C" * 60)):
        g.add_contig(Contig(seq=seq, cov=10.0, left=End(X, slot),
                            right=End(far, 4)))
    for far, slot, seq in ((C, 4, "G" * 60), (D, 5, "T" * 60)):
        g.add_contig(Contig(seq=seq, cov=10.0, left=End(far, 0),
                            right=End(X, slot)))
    canon = lambda s: min(s, TK.revcomp_seq(s))
    evidence = {frozenset((canon(A), canon(C))),
                frozenset((canon(B), canon(D)))}
    return g, lambda a, b: 5 if frozenset((a, b)) in evidence else 0


def test_disentangle_nodes_ignores_refused_merges():
    """The mirrored fault: with both merges of the resolved node refused
    (returning False, changing nothing), _disentangle_nodes still counts
    the node as resolved, in the port as in the reference."""
    out = []
    for mod, make in ((TH, lambda g: g), (JH, to_ref)):
        g, pair_count = _planted_repeat_node()
        pc = mod.PartitionedCleaner(make(g), N)
        refused = []

        def refuse(*a):
            refused.append(a[1:])
            return False

        pc._merge = refuse
        out.append((pc.disentangle(pair_count), refused,
                    _sig(pc.result())))
    (t_n, t_ref, t_sig), (j_n, j_ref, j_sig) = out
    assert len(t_ref) == 2 and t_ref == j_ref  # both merges refused
    assert t_n == j_n == 1    # ... yet the node counts as resolved
    assert t_sig == j_sig == _sig(_planted_repeat_node()[0])  # unchanged
