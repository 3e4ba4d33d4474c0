"""Pipeline orchestrator (port of faucet_tpu/pipeline.py).

load -> scan -> (checkpoint) -> build -> clean -> emit, on one torch
device. Device phases run batch by batch on `device`; the compact graph
is extracted to the host for cleaning and emission. `run_file_mode`
makes two passes over the reads, `run_streaming` one (insert, then scan,
each batch). Reads are consumed batch by batch and never stored.

Ported scope: one device, k <= 31, Bloom mode, branch-node junctions.
Paired ends, exact mode, ext8, wide k, sharding and prune_slots raise
NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from faucet_tpu.config import Config
from faucet_tpu.metrics import Metrics
from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import scan as SC
from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.core.kmer import pack_reads
from faucet_tpu_torch.graph.build import GraphBuilder
from faucet_tpu_torch.graph.clean import clean
from faucet_tpu_torch.graph.model import ContigGraph


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


def check_supported(cfg: Config):
    """Refuse configurations whose features are not ported yet."""
    unported = [
        (cfg.paired_ends, "paired ends"),
        (cfg.exact, "exact mode"),
        (cfg.size_kmer > 31, "wide k (k > 31)"),
        (not cfg.use_node_junctions, "ext8 junction detection"),
        (cfg.n_shards > 1, "dist/ (n_shards > 1)"),
        (cfg.prune_slot_cov > 0, "prune_slots (prune_slot_cov > 0)"),
    ]
    for bad, item in unported:
        if bad:
            raise NotImplementedError(
                f"{item} is not ported to faucet_tpu_torch; see ROADMAP.md "
                f"({item})")


def resolve_device(device) -> torch.device:
    """A CUDA request without a card raises; it never falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available")
    return device


class Pipeline:
    def __init__(self, cfg: Config, metrics: Optional[Metrics] = None,
                 device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.metrics = metrics or Metrics(cfg.metrics_file)
        self.cascade = BL.make_cascade(cfg, dev)
        # branch-node cascade: junction detection via 2 node probes per
        # window (core/nodes.py)
        self.node_cascade = BL.make_cascade(cfg.node_view(), dev)
        self.junctions = T.make(
            cfg.junction_cap, (((8,), torch.int32), ((8,), torch.int32)),
            device=dev)
        self.sinks = T.make(cfg.sink_cap, (((), torch.int32),), device=dev)
        # cross-batch junction-update spool: scan batches append; phase
        # ends flush (core/scan.JSpool)
        self.jspool = (SC.make_jspool(cfg, dev) if cfg.spool_junctions
                       else None)

    def flush_junctions(self):
        """Drain the junction spool into the table (idempotent; called at
        scan/stream phase ends, so checkpoint save and graph build always
        see the complete table)."""
        if self.jspool is not None and self.jspool.cnt > 0:
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

        m = self.metrics
        m.start("load")
        for bases, lens in prefetch_batches(batches, self.device):
            self.load_batch(bases, lens)
        self._sync()
        m.stop("load")

    def load_batch(self, bases, lens):
        self.cascade, self.node_cascade, _n_new = SC.load_batch_nodes(
            self.cascade, self.node_cascade, self._bases(bases),
            self._lens(lens), cfg=self.cfg)
        self.metrics.add("reads_loaded", int((np.asarray(lens) > 0).sum()))

    def _bases(self, bases):
        if isinstance(bases, np.ndarray):
            bases = torch.from_numpy(bases)
        return bases.to(self.device)

    # ---- phase 2 ---------------------------------------------------------
    def scan_reads(self, reads: Iterable[str]):
        self.scan_batches(batch_iter(reads, self.cfg))

    def scan_batches(self, batches):
        from faucet_tpu_torch.io.stream import prefetch_batches

        m = self.metrics
        m.start("scan")
        for bases, lens in prefetch_batches(batches, self.device):
            self.scan_batch(bases, lens)
        self.flush_junctions()
        self._sync()
        m.stop("scan")

    def scan_batch(self, bases, lens, window_solid=None):
        res = SC.scan_batch(self.cascade, self.junctions, self.sinks,
                            self._bases(bases), self._lens(lens),
                            cfg=self.cfg, node_cascade=self.node_cascade,
                            window_solid=window_solid, jspool=self.jspool)
        self.junctions = res.junctions
        self.sinks = res.sinks
        if res.jspool is not None:
            self.jspool = res.jspool
        self.metrics.add("reads_scanned", int((np.asarray(lens) > 0).sum()))
        self.metrics.add("solid_windows", int(res.n_solid))
        self.metrics.add("junction_hits", int(res.n_junc_pos))
        return res

    def stream_step(self, bases, lens):
        """Fused single-pass step: insert the batch, then scan it with
        the window solidity the insert pass computed (the scan's own
        window probe disappears)."""
        bases = self._bases(bases)
        (self.cascade, self.node_cascade, _n,
         ws) = SC.load_batch_nodes_s(self.cascade, self.node_cascade,
                                     bases, self._lens(lens), cfg=self.cfg)
        self.metrics.add("reads_loaded", int((np.asarray(lens) > 0).sum()))
        return self.scan_batch(bases, lens, window_solid=ws)

    # ---- phases 3-5 ------------------------------------------------------
    def build(self) -> ContigGraph:
        m = self.metrics
        # defensive: callers driving scan_batch directly may not have hit
        # a phase-end flush
        self.flush_junctions()
        m.start("build")
        g = GraphBuilder(self.cfg, self.cascade, self.junctions,
                         self.sinks).build()
        m.stop("build")
        m.add("junctions", int(self.junctions.count))
        m.add("junctions_dropped", int(self.junctions.dropped))
        m.add("sink_anchors", int(self.sinks.count))
        m.add("sinks_dropped", int(self.sinks.dropped))
        m.add("contigs_raw", len(g.live()))
        return g

    def clean_graph(self, g: ContigGraph) -> ContigGraph:
        cfg = self.cfg
        if cfg.no_cleaning:
            return g
        m = self.metrics
        m.start("clean")
        st = clean(g,
                   max_tip_len=int(cfg.tip_len_factor * cfg.max_read_length),
                   min_cov=cfg.min_contig_cov, pair_count=None)
        m.stop("clean")
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
        """Single-pass stream: each batch is inserted, then scanned."""
        return self.run_streaming_batches(batch_iter(reads, self.cfg))

    def run_streaming_batches(self, batches) -> ContigGraph:
        """Single-pass stream over packed (bases, lens) batches."""
        from faucet_tpu_torch.io.stream import prefetch_batches

        m = self.metrics
        m.start("stream")
        for bases, lens in prefetch_batches(batches, self.device):
            self.stream_step(bases, lens)
        self.flush_junctions()
        self._sync()
        m.stop("stream")
        return self._finish()
