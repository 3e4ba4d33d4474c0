"""A run with the timed path broken underneath comes out not correct:
run_cell drives everything but the look for a chip (on the CPU, tiny
cells), with one fault planted in the program at a time. The cells run
on one chip, so there is no exchange between chips to leave out."""
import numpy as np
import pytest
import torch

from benchmark import check, run
from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import scan as SC
from faucet_tpu_torch.graph.model import Contig
from faucet_tpu_torch.pipeline import Pipeline

from benchmark.tests.helpers import tiny


def _unchanged_state(mp):
    """The cascade insert returns its filters as they were."""
    def insert(c, khi, klo, mask, cfg, sparse=False):
        z = torch.zeros_like(mask)
        return c, z, z
    mp.setattr(BL, "cascade_insert_nbs", insert)


def _half_batch(mp):
    """The load half of each batch's reads left out."""
    for name in ("load_batch", "stream_step"):
        orig = getattr(Pipeline, name)

        def half(self, bases, lens, _orig=orig):
            lens = np.array(lens)
            lens[: len(lens) // 2] = 0
            return _orig(self, bases, lens)
        mp.setattr(Pipeline, name, half)


def _altered_cov(mp):
    """A junction record's coverage altered where the scan makes it."""
    orig = SC.cov_dist8

    def cov_dist8(*a):
        cov8, dist8 = orig(*a)
        return cov8 + (torch.arange(cov8.numel()).view(cov8.shape) == 0), \
            dist8
    mp.setattr(SC, "cov_dist8", cov_dist8)


def _altered_contig(mp):
    """A base of the longest contig altered where cleaning hands it on."""
    orig = Pipeline.clean_graph

    def clean_graph(self, g):
        g = orig(self, g)
        c = max((g.contigs[i] for i in g.live()), key=len)
        i = len(c.seq) // 2
        c.seq = c.seq[:i] + ("A" if c.seq[i] != "A" else "C") + c.seq[i + 1:]
        return g
    mp.setattr(Pipeline, "clean_graph", clean_graph)


def _contigs_split(mp):
    """Each contig split at its middle, as a walk that stops early leaves
    it: the halves overlap by k - 1 bases, so no k-mer is lost."""
    orig = Pipeline.clean_graph

    def clean_graph(self, g):
        g = orig(self, g)
        k = self.cfg.k
        for i in g.live():
            c = g.contigs[i]
            m = len(c.seq) // 2
            if len(c.seq) >= 2 * k:
                g.add_contig(Contig(seq=c.seq[m:]))
                c.seq = c.seq[:m + k - 1]
        return g
    mp.setattr(Pipeline, "clean_graph", clean_graph)


def _contigs_truncated(mp):
    """Each contig's last two bases dropped. Its last k-mer is the
    junction node that the next contig starts with; the k-mer before
    it, its own, is lost."""
    orig = Pipeline.clean_graph

    def clean_graph(self, g):
        g = orig(self, g)
        for i in g.live():
            g.contigs[i].seq = g.contigs[i].seq[:-2]
        return g
    mp.setattr(Pipeline, "clean_graph", clean_graph)


FAULTS = {"unchanged_state": (_unchanged_state, "filter_words_differ"),
          "half_batch": (_half_batch, "filter_words_differ"),
          "altered_cov": (_altered_cov, "junction_rows_differ"),
          "altered_contig": (_altered_contig, "contig_untrue_share"),
          "split_contigs": (_contigs_split, "contig_n50_shortfall"),
          "truncated_contigs": (_contigs_truncated, "genome_kmers_missing")}
CASES = [("ecoli-k31.assemble", f) for f in
         ("unchanged_state", "half_batch", "altered_contig",
          "split_contigs", "truncated_contigs")] + \
        [("saureus-k55.ingest", f) for f in
         ("unchanged_state", "half_batch", "altered_cov")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    """The number the fault moves reads 0 in the sound run and over its
    limit with the fault. (At these tiny genomes the sound assembly can
    itself miss a chunk of the genome, PERF.md's open questions, so the
    sound run is held to this number and not to the whole verdict.)"""
    # contigs of the 8 kbp genome are chimeric through its repeats, and
    # the 30 kbp genome's assembly pops one of its equal chunks; that of
    # the 60 kbp genome is genome-true and whole, so a contig fault shows
    spec = tiny(cell, genome_len=60_000 if "contig" in fault else 8000)
    plant, number = FAULTS[fault]
    sound = run.run_cell(spec, 31, 0.2, False, device="cpu")["numbers"]
    assert sound[number] <= 0
    plant(monkeypatch)
    res = run.run_cell(spec, 31, 0.2, False, device="cpu")
    assert res["numbers"][number] > check.LIMITS[number]
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] > 0
