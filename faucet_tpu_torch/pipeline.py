"""Pipeline orchestrator (port of faucet_tpu/pipeline.py).

load -> scan -> (checkpoint) -> build -> clean -> emit, on one torch
device. Device phases run batch by batch on `device`; the compact graph
is extracted to the host for cleaning and emission. `run_file_mode`
makes two passes over the reads, `run_streaming` one (insert, then scan,
each batch). Reads are consumed batch by batch and never stored.

Scope: everything the reference's Pipeline runs: k <= 63 (wide codes
above 31), Bloom and exact mode, branch-node and ext8 junctions, paired
ends, the prune_slots pre-clean, and the chunks of a dual-k second pass
(`contig_chunks`; the CLI joins the two passes). A config with n_shards >
1 runs here on one device in the owner-prefixed global layout; the
sharded run over one process per shard is dist/sharded.py.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from faucet_tpu_torch.config import Config
from faucet_tpu_torch.metrics import Metrics
from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import scan as SC
from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.core.kmer import pack_reads
from faucet_tpu_torch.device import resolve_device
from faucet_tpu_torch.dist.sharded import prune_slots
from faucet_tpu_torch.graph.build import GraphBuilder
from faucet_tpu_torch.graph.clean import clean
from faucet_tpu_torch.graph.model import ContigGraph


def contig_chunks(g: ContigGraph, max_len: int, k: int) -> List[str]:
    """Chunk first-pass contigs into read-sized windows for a second pass
    at larger k (the dual-k workflow, BASELINE.md configuration 2).

    Windows overlap by k-1 so every k-mer of a contig survives chunking;
    a circular contig is extended by its first k-1 bases; each chunk is
    emitted twice so the cascade marks its k-mers solid."""
    out: List[str] = []
    stride = max(1, max_len - (k - 1))
    for i in g.live():
        c = g.contigs[i]
        seq = c.seq + (c.seq[: k - 1] if c.circular else "")
        for start in range(0, max(1, len(seq) - k + 1), stride):
            w = seq[start : start + max_len]
            if len(w) >= k:
                out.append(w)
                out.append(w)
    return out


def batch_iter(reads: Iterable[str], cfg: Config
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Pack a read stream into fixed-shape [batch_reads, max_read_length]
    uint8 batches."""
    buf: List[str] = []
    for r in reads:
        buf.append(r)
        if len(buf) == cfg.batch_reads:
            yield pack_reads(buf, cfg.max_read_length)
            buf = []
    if buf:
        buf += [""] * (cfg.batch_reads - len(buf))
        yield pack_reads(buf, cfg.max_read_length)


class Pipeline:
    def __init__(self, cfg: Config, metrics: Optional[Metrics] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.metrics = metrics or Metrics(cfg.metrics_file)
        self.cascade = BL.make_cascade(cfg, dev)
        # branch-node cascade: junction detection via 2 node probes per
        # window (core/nodes.py) instead of the 8-way extension probe
        self.node_cascade = (BL.make_cascade(cfg.node_view(), dev)
                             if cfg.use_node_junctions else None)
        # wide k-mers (k > 31) store their 4 canonical code words as a
        # table value, so walks can seed from fingerprint-keyed entries;
        # int64 holding uint32 words, so "max" keeps the unsigned order
        wspec = (((4,), torch.int64),) if cfg.wide else ()
        self.junctions = T.make(
            cfg.junction_cap,
            (((8,), torch.int32), ((8,), torch.int32)) + wspec, device=dev)
        self.sinks = T.make(cfg.sink_cap, (((), torch.int32),) + wspec,
                            device=dev)
        self.pairs = T.make(cfg.pair_cap, (((), torch.int32),), device=dev)
        # cross-batch junction-update spool (narrow keys): scan batches
        # append; phase ends flush (core/scan.JSpool)
        self.jspool = (SC.make_jspool(cfg, dev)
                       if cfg.spool_junctions and not cfg.wide else None)

    def flush_junctions(self):
        """Drain the junction spool into the table (idempotent; called at
        scan/stream phase ends, so checkpoint save and graph build always
        see the complete table)."""
        if self.jspool is not None and self.jspool.cnt > 0:
            with self.metrics.span("flush"):
                self.junctions, self.jspool = SC.spool_flush(
                    self.junctions, self.jspool, self.cfg)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lens(self, lens):
        return torch.from_numpy(np.asarray(lens)).to(self.device)

    # ---- phase 1 ---------------------------------------------------------
    def load_reads(self, reads: Iterable[str]):
        self.load_batches(batch_iter(reads, self.cfg))

    def load_batches(self, batches):
        """Phase 1 over an iterator of (bases, lens) packed batches,
        prefetched on a reader thread (io/stream.py)."""
        from faucet_tpu_torch.io.stream import prefetch_batches

        with self.metrics.span("load"):
            for bases, lens in prefetch_batches(batches, self.device):
                self.load_batch(bases, lens)
            self._sync()

    def load_batch(self, bases, lens):
        with self.metrics.span("load_batch"):
            self._insert(bases, lens)

    def _insert(self, bases, lens):
        """Insert a batch into the cascade(s); returns (bases on the
        device, the windows' B-solidity grid)."""
        bases, lens_d = self._bases(bases), self._lens(lens)
        if self.node_cascade is not None:
            (self.cascade, self.node_cascade, _n,
             ws) = SC.load_batch_nodes_s(self.cascade, self.node_cascade,
                                         bases, lens_d, cfg=self.cfg)
        else:
            self.cascade, ws = SC.load_batch_s(self.cascade, bases, lens_d,
                                               cfg=self.cfg)
        self.metrics.add("reads_loaded", int((np.asarray(lens) > 0).sum()))
        return bases, ws

    def _bases(self, bases):
        if isinstance(bases, np.ndarray):
            bases = torch.from_numpy(bases)
        return bases.to(self.device)

    # ---- phase 2 ---------------------------------------------------------
    def scan_reads(self, reads: Iterable[str]):
        self.scan_batches(batch_iter(reads, self.cfg))

    def scan_batches(self, batches):
        from faucet_tpu_torch.io.stream import prefetch_batches

        with self.metrics.span("scan"):
            for bases, lens in prefetch_batches(batches, self.device):
                self.scan_batch(bases, lens)
            self.flush_junctions()
            self._sync()

    def scan_batch(self, bases, lens, window_solid=None):
        m = self.metrics
        with m.span("scan_batch"):
            res = SC.scan_batch(self.cascade, self.junctions, self.sinks,
                                self._bases(bases), self._lens(lens),
                                cfg=self.cfg, node_cascade=self.node_cascade,
                                window_solid=window_solid, jspool=self.jspool)
            self.junctions = res.junctions
            self.sinks = res.sinks
            if res.jspool is not None:
                self.jspool = res.jspool
            m.add("reads_scanned", int((np.asarray(lens) > 0).sum()))
            m.add("solid_windows", res.n_solid)
            m.add("junction_hits", res.n_junc_pos)
        return res

    def stream_step(self, bases, lens):
        """Fused single-pass step: insert the batch, then scan it with
        the window solidity the insert pass computed (the scan's own
        window probe disappears)."""
        m = self.metrics
        with m.span("stream_step"):
            with m.span("load"):
                bases, ws = self._insert(bases, lens)
            return self.scan_batch(bases, lens, window_solid=ws)

    def scan_paired(self, reads: Iterable[str]):
        """Scan an interleaved mate stream; captures junction pairs for
        disentanglement alongside the normal junction updates."""
        with self.metrics.span("scan"):
            for packed in self._mate_batches(reads):
                self._scan_pair_packed(*packed)
            self.flush_junctions()
            self._sync()

    def _mate_batches(self, reads: Iterable[str]):
        """Interleaved mates -> packed (bases1, lens1, bases2, lens2), up
        to batch_reads pairs each (the last batch padded)."""
        from faucet_tpu_torch.io.fastq import deinterleave

        B, L = self.cfg.batch_reads, self.cfg.max_read_length
        m1, m2 = [], []
        for a, b in deinterleave(iter(reads)):
            m1.append(a)
            m2.append(b)
            if len(m1) == B:
                yield pack_reads(m1, L) + pack_reads(m2, L)
                m1, m2 = [], []
        if m1:
            pad = [""] * (B - len(m1))
            yield pack_reads(m1 + pad, L) + pack_reads(m2 + pad, L)

    def _scan_pair_packed(self, b1, l1, b2, l2):
        r1 = self.scan_batch(b1, l1)
        r2 = self.scan_batch(b2, l2)
        self.pairs = SC.capture_pairs(self.pairs, r1, r2, cfg=self.cfg)
        self.metrics.add("pair_batches", 1)

    def scan_paired_batches(self, batches):
        """Paired scan over packed interleaved batches (the native C++
        reader feeds this): mates are alternating rows, split even/odd.
        Row counts must be even."""
        from faucet_tpu_torch.io.stream import prefetch_batches

        with self.metrics.span("scan"):
            for bases, lens in prefetch_batches(batches, self.device):
                self._scan_pair_packed(bases[0::2], lens[0::2], bases[1::2],
                                       lens[1::2])
            self.flush_junctions()
            self._sync()

    def pair_counts(self):
        """Host dict: pair-hash key -> count (consumed by disentangle)."""
        from faucet_tpu_torch.graph.build import extract_table

        t = extract_table(self.pairs)
        return {(int(h) << 32) | int(l): int(c)
                for h, l, c in zip(t["hi"], t["lo"], t["v0"])}

    # ---- phases 3-5 ------------------------------------------------------
    def build(self) -> ContigGraph:
        m = self.metrics
        # defensive: callers driving scan_batch directly may not have hit
        # a phase-end flush
        self.flush_junctions()
        if self.cfg.prune_slot_cov > 0:
            self.junctions = prune_slots(self.junctions,
                                         self.cfg.prune_slot_cov)
        with m.span("build"):
            g = GraphBuilder(self.cfg, self.cascade, self.junctions,
                             self.sinks).build()
        m.add("junctions", self.junctions.count)
        m.add("junctions_dropped", self.junctions.dropped)
        m.add("sink_anchors", self.sinks.count)
        m.add("sinks_dropped", self.sinks.dropped)
        m.add("contigs_raw", len(g.live()))
        return g

    def _pair_count_fn(self):
        """Host pair-evidence lookup over node k-mer strings, or None."""
        counts = self.pair_counts()
        if not counts:
            return None
        from faucet_tpu_torch.core.hashing import pair_key_np
        from faucet_tpu_torch.core.kmer import encode_kmer

        def pc(a: str, b: str) -> int:
            ah, al = encode_kmer(a)
            bh, bl = encode_kmer(b)
            kh, kl = pair_key_np(np.uint32(ah), np.uint32(al),
                                 np.uint32(bh), np.uint32(bl))
            return counts.get((int(kh) << 32) | int(kl), 0)

        return pc

    def clean_graph(self, g: ContigGraph) -> ContigGraph:
        cfg = self.cfg
        if cfg.no_cleaning:
            return g
        m = self.metrics
        with m.span("clean"):
            st = clean(g, max_tip_len=int(cfg.tip_len_factor
                                          * cfg.max_read_length),
                       min_cov=cfg.min_contig_cov,
                       pair_count=(self._pair_count_fn()
                                   if cfg.paired_ends else None))
        for k, v in st.items():
            m.add(f"clean_{k}", v)
        return g

    def _finish(self) -> ContigGraph:
        g = self.clean_graph(self.build())
        self.metrics.add("contigs", len(g.live()))
        self.metrics.emit("assembly_done", stats=g.stats())
        return g

    # ---- end-to-end ------------------------------------------------------
    def run_file_mode(self, load_reads: Iterable[str],
                      scan_reads: Iterable[str]) -> ContigGraph:
        """Two-pass mode (-read_load_file / -read_scan_file)."""
        self.load_reads(load_reads)
        self.scan_reads(scan_reads)
        return self._finish()

    def run_streaming(self, reads: Iterable[str]) -> ContigGraph:
        """Single-pass stream: each batch is inserted, then scanned. With
        paired_ends the stream is interleaved mates: both mate batches
        (batch_reads each) are inserted, then pair-scanned."""
        if not self.cfg.paired_ends:
            return self.run_streaming_batches(batch_iter(reads, self.cfg))
        with self.metrics.span("stream"):
            for packed in self._mate_batches(reads):
                self._stream_pair_packed(*packed)
            self.flush_junctions()
            self._sync()
        return self._finish()

    def _stream_pair_packed(self, b1, l1, b2, l2):
        self.load_batch(b1, l1)
        self.load_batch(b2, l2)
        self._scan_pair_packed(b1, l1, b2, l2)

    def run_streaming_batches(self, batches) -> ContigGraph:
        """Single-pass stream over packed (bases, lens) batches; with
        paired_ends, mates are the alternating rows of each batch (load
        both halves, then pair-scan)."""
        from faucet_tpu_torch.io.stream import prefetch_batches

        with self.metrics.span("stream"):
            for bases, lens in prefetch_batches(batches, self.device):
                if self.cfg.paired_ends:
                    self._stream_pair_packed(bases[0::2], lens[0::2],
                                             bases[1::2], lens[1::2])
                else:
                    self.stream_step(bases, lens)
            self.flush_junctions()
            self._sync()
        return self._finish()
