# Copied from faucet_tpu/config.py (only the `profile` comment differs):
# the port imports nothing of faucet_tpu. Field names, defaults and
# derived values must stay identical (the checkpoint hash, ckpt/state.py
# _cfg_hash, reads them).
"""Configuration for the faucet_tpu pipeline.

Mirrors the reference CLI surface (SURVEY.md §5 "Config / flag system":
``-read_load_file``, ``-read_scan_file``, ``-size_kmer``, ``-max_read_length``,
``-estimated_kmers``, ``-singletons``, ``-file_prefix``, ``--fastq``,
``--paired_ends``, ``--no_cleaning``, ``-bloom_file``, ``-junctions_file``)
as a dataclass, and adds TPU-only knobs (mesh/shard shape, batch size,
exact-membership mode, profiling).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional


def _next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- reference-compatible surface -----------------------------------
    read_load_file: Optional[str] = None   # reads used for Bloom cascade load
    read_scan_file: Optional[str] = None   # reads used for junction scan
    size_kmer: int = 31                    # k (odd, <= 31 for 2-word codes)
    max_read_length: int = 256             # static read-batch width
    estimated_kmers: int = 1 << 22         # distinct solid k-mers estimate
    singletons: int = 1 << 22              # distinct singleton (error) k-mers
    file_prefix: str = "faucet_tpu_out"    # output path prefix
    fastq: bool = False                    # input is FASTQ (else FASTA)
    paired_ends: bool = False              # capture junction pairs from mates
    no_cleaning: bool = False              # skip graph cleaning passes
    bloom_file: Optional[str] = None       # resume: serialized Bloom B
    junctions_file: Optional[str] = None   # resume: serialized junction map
    fp_rate: float = 0.01                  # Bloom target false-positive rate
    two_hash: bool = False                 # legacy knob: cap n_hash at 2

    # ---- TPU-native knobs ----------------------------------------------
    batch_reads: int = 4096                # reads per device batch
    exact: bool = False                    # exact hash-set membership (golden)
    n_shards: int = 1                      # hash-range shards (mesh axis size)
    junction_capacity: Optional[int] = None  # open-addressing table slots
    sink_capacity: Optional[int] = None
    pair_capacity: Optional[int] = None
    bloom_a_log2_override: Optional[int] = None  # exact sizes pinned by
    bloom_b_log2_override: Optional[int] = None  # local_shard(): shard-
    cascade_cap_a_override: Optional[int] = None  # local sizes must be
    cascade_cap_b_override: Optional[int] = None  # exactly global/n_shards
    n_hash_a_override: Optional[int] = None  # pinned by local_shard() so
    n_hash_b_override: Optional[int] = None  # shard bits == global bits
    junction_detect: str = "auto"   # auto | nodes | ext8 (SURVEY §3.2:
    #   nodes = branch-node cascade, 2 probes/window; ext8 = the
    #   reference-style 8-way extension probe; auto: nodes for k<=31)
    bloom_d_log2_override: Optional[int] = None  # branch-node cascade
    bloom_e_log2_override: Optional[int] = None  # (D = seen-once
    n_hash_d_override: Optional[int] = None      # node-sides, E =
    n_hash_e_override: Optional[int] = None      # branching node-sides)
    node_cap_d_override: Optional[int] = None
    node_cap_e_override: Optional[int] = None
    max_contig_len: int = 8_000_000        # global walk bound (bases) —
    #   a cap, not a cost: frontier compaction makes walk work ~sum of
    #   walk lengths, and strips stream to host per wave call, so the
    #   bound only needs to exceed the longest real unitig (200k cut
    #   every >200kb unitig at 4+ Mbp scale, VERDICT r2 #2)
    break_on_deep_tie: bool = False        # walks: retire (True) or
    #   force-continue (False) when >=2 branch candidates survive the
    #   deep lookahead — both paths real, almost always a shadowed error
    #   bubble's arms that rejoin (graph/walk.py resolve_ambiguous)
    fp_lookahead: int = 8                  # walk fp-branch arbitration depth:
    #   at an ambiguous step each solid candidate must survive this many
    #   greedy extension steps through B; a Bloom-fp chain survives with
    #   P ~ (4*fp_rate)^depth, so 8 makes a stuck walk ~never (the
    #   reference's serial walk never stalls because its dist bound picks
    #   the path; the lockstep walk arbitrates locally instead)
    scan_update_cap: int = 1 << 13         # junction/sink update lanes kept
    #   per batch after compaction (sparse in practice; overflow counted)
    spool_junctions: bool = True           # single-shard narrow-k scans:
    #   defer junction-table upserts into a cross-batch HBM spool and
    #   flush (sort + per-key combine + upsert of unique reps) at phase
    #   ends — same table contents, ~amortized-away per-batch upsert
    #   cost (core/scan.JSpool; round-4 perf)
    walk_round_steps: int = 256            # frontier steps per walk round
    walk_rounds_per_call: int = 8          # rounds folded into one device
    #   dispatch (lax.while_loop with early exit); bounds per-call strip
    #   memory at [W, rounds*steps] u8 while cutting host syncs 8x
    tip_len_factor: float = 2.0            # clean: tips shorter than f*read_len
    min_contig_cov: float = 2.5            # clean: drop contigs below this cov
    route_walks: bool = True               # sharded pipelines: walk hops
    #   route frontier k-mers to their hash-range owner shard through
    #   dist/route.py's explicit all_to_all (bytes counted) instead of
    #   XLA GSPMD auto-partitioning the probes (dist/swalk.py; k<=31)
    distributed_clean: bool = False        # sharded pipelines: clean the
    #   graph with the halo-exchange partitioned cleaner (dist/halo.py)
    #   instead of the single-host passes — contig-set-identical
    #   (tests/dist/test_halo.py), O(cut) boundary traffic per round
    prune_slot_cov: int = 0                # device pre-clean: zero junction
    #   slots below this cov BEFORE walking (shard-local pass over the
    #   hash-range-owned table; the distributed analog of low-cov contig
    #   deletion for metagenome-scale graphs — BASELINE config 5). 0 = off.
    #   (default sits above the cov==2 islands that doubled sequencing
    #    errors create, below any real path at >=3x depth)
    profile: bool = False                  # torch.profiler Chrome trace
    metrics_file: Optional[str] = None     # JSONL metrics sink
    seed: int = 0

    def __post_init__(self):
        if self.size_kmer % 2 == 0:
            raise ValueError("size_kmer must be odd (canonical form requires it)")
        if not (1 < self.size_kmer <= 63):
            raise ValueError("size_kmer must be odd and in (1, 63]: "
                             "2-word codes up to k=31, 4-word wide codes "
                             "with fingerprint keys above")
        if self.max_read_length <= self.size_kmer:
            raise ValueError("max_read_length must exceed size_kmer")
        if self.n_shards & (self.n_shards - 1):
            raise ValueError("n_shards must be a power of two")
        if self.junction_detect not in ("auto", "nodes", "ext8"):
            raise ValueError("junction_detect must be auto|nodes|ext8")
        if self.junction_detect == "nodes" and self.size_kmer > 31:
            raise ValueError("junction_detect=nodes needs k <= 31 "
                             "(wide k-mers use fingerprint keys; node "
                             "codes are not derivable from them)")

    # ---- derived sizes --------------------------------------------------
    @property
    def k(self) -> int:
        return self.size_kmer

    @property
    def wide(self) -> bool:
        """k > 31: 4-word codes, fingerprint table keys (core/wide.py)."""
        return self.size_kmer > 31

    @property
    def positions_per_read(self) -> int:
        return self.max_read_length - self.size_kmer + 1

    @property
    def n_hash(self) -> int:
        """Optimal Bloom hash count for fp_rate, reference-style sizing."""
        if self.two_hash:
            return 2
        return max(1, round(-math.log2(self.fp_rate)))

    def _min_hashes(self, m_bits: int, n_items: int) -> int:
        """Smallest hash count meeting fp_rate at the pow2-rounded size.

        TPU redesign: the reference uses the information-optimal count for
        its exact sizing; our power-of-two rounding leaves bits/key slack,
        so FEWER hashes reach the same fp target — and every hash is a
        VPU op in the probe/insert kernels. The 1.25 load inflation
        covers the 512-bit blocked layout's per-block variance penalty
        (measured fp stays under fp_rate, tests/unit/test_bloom.py)."""
        if self.two_hash:
            return 2
        n_eff = max(1, int(1.25 * n_items))
        for k in range(1, 17):
            if (1 - math.exp(-k * n_eff / m_bits)) ** k <= self.fp_rate:
                return k
        return max(1, round(-math.log2(self.fp_rate)))

    @property
    def n_hash_a(self) -> int:
        if self.n_hash_a_override is not None:
            return self.n_hash_a_override
        return self._min_hashes(self.bloom_a_bits,
                                self.estimated_kmers + self.singletons)

    @property
    def n_hash_b(self) -> int:
        if self.n_hash_b_override is not None:
            return self.n_hash_b_override
        return self._min_hashes(self.bloom_b_bits, self.estimated_kmers)

    # ---- branch-node cascade (junction_detect == "nodes") ----------------
    @property
    def use_node_junctions(self) -> bool:
        if self.junction_detect == "auto":
            return self.size_kmer <= 31
        return self.junction_detect == "nodes"

    @property
    def node_fp_rate(self) -> float:
        """A false positive here forges a junction (one extra collapsible
        graph node, like the reference's Bloom-fp junctions) — keep it an
        order under the membership fp."""
        return min(self.fp_rate, 0.002)

    @property
    def node_d_items(self) -> int:
        return 2 * self.estimated_kmers  # two endpoints per solid k-mer

    @property
    def node_e_items(self) -> int:
        return max(self.estimated_kmers // 2, 1 << 14)

    def _node_bits(self, n_items: int) -> int:
        # sized so THREE hashes reach node_fp_rate (~24 bits/key at
        # 0.2%): every hash is a VPU mask op in the probe/insert kernels
        # and the scan asks 2 node probes per window — HBM bits are far
        # cheaper than per-probe compute (bench/nodes_profile.py)
        import math as _m

        per_key = 3.0 / -_m.log1p(-self.node_fp_rate ** (1 / 3))
        bits = int(1.25 * n_items * per_key)
        return _next_pow2(max(bits, 1 << 16))

    @property
    def bloom_d_bits(self) -> int:
        if self.bloom_d_log2_override is not None:
            return 1 << self.bloom_d_log2_override
        return self._node_bits(self.node_d_items)

    @property
    def bloom_e_bits(self) -> int:
        if self.bloom_e_log2_override is not None:
            return 1 << self.bloom_e_log2_override
        return self._node_bits(self.node_e_items)

    def _min_hashes_at(self, m_bits: int, n_items: int, fp: float) -> int:
        if self.two_hash:
            return 2
        n_eff = max(1, int(1.25 * n_items))
        for k in range(1, 17):
            if (1 - math.exp(-k * n_eff / m_bits)) ** k <= fp:
                return k
        return max(1, round(-math.log2(fp)))

    @property
    def n_hash_d(self) -> int:
        if self.n_hash_d_override is not None:
            return self.n_hash_d_override
        return self._min_hashes_at(self.bloom_d_bits, self.node_d_items,
                                   self.node_fp_rate)

    @property
    def n_hash_e(self) -> int:
        if self.n_hash_e_override is not None:
            return self.n_hash_e_override
        return self._min_hashes_at(self.bloom_e_bits, self.node_e_items,
                                   self.node_fp_rate)

    @property
    def node_cap_d(self) -> int:
        if self.node_cap_d_override is not None:
            return self.node_cap_d_override
        return _next_pow2(2 * self.node_d_items)

    @property
    def node_cap_e(self) -> int:
        if self.node_cap_e_override is not None:
            return self.node_cap_e_override
        return _next_pow2(2 * self.node_e_items)

    def node_view(self) -> "Config":
        """This config with the A/B slots remapped to the branch-node
        cascade D/E — the node cascade then reuses the generic Cascade
        machinery (make_cascade / cascade_insert_nbs / cascade_solid)
        verbatim, including exact-table mode and sharded addressing."""
        import dataclasses as _dc

        return _dc.replace(
            self,
            bloom_a_log2_override=self.bloom_d_bits.bit_length() - 1,
            bloom_b_log2_override=self.bloom_e_bits.bit_length() - 1,
            n_hash_a_override=self.n_hash_d,
            n_hash_b_override=self.n_hash_e,
            cascade_cap_a_override=self.node_cap_d,
            cascade_cap_b_override=self.node_cap_e)

    def bloom_bits(self, n_items: int) -> int:
        """Bits for an n_items Bloom at fp_rate; rounded to a power of two
        so that modular reduction is a mask (TPU-friendly)."""
        bits = int(-n_items * math.log(self.fp_rate) / (math.log(2) ** 2))
        return _next_pow2(max(bits, 1 << 16))

    @property
    def bloom_a_bits(self) -> int:
        if self.bloom_a_log2_override is not None:
            return 1 << self.bloom_a_log2_override
        return self.bloom_bits(self.estimated_kmers + self.singletons)

    @property
    def bloom_b_bits(self) -> int:
        if self.bloom_b_log2_override is not None:
            return 1 << self.bloom_b_log2_override
        return self.bloom_bits(self.estimated_kmers)

    @property
    def cascade_cap_a(self) -> int:
        if self.cascade_cap_a_override is not None:
            return self.cascade_cap_a_override
        return _next_pow2(2 * (self.estimated_kmers + self.singletons))

    @property
    def cascade_cap_b(self) -> int:
        if self.cascade_cap_b_override is not None:
            return self.cascade_cap_b_override
        return _next_pow2(2 * self.estimated_kmers)

    @property
    def junction_cap(self) -> int:
        if self.junction_capacity is not None:
            return _next_pow2(self.junction_capacity)
        # junctions are a small fraction of solid k-mers; over-provision 2x
        # headroom at 0.5 load factor.
        return _next_pow2(max(1 << 12, self.estimated_kmers // 8))

    @property
    def sink_cap(self) -> int:
        if self.sink_capacity is not None:
            return _next_pow2(self.sink_capacity)
        # distinct sink anchors are read-end k-mers: bounded by genome
        # positions (~estimated_kmers), commonly a large fraction of them
        # at high coverage — keep load factor <= 0.5 at that bound
        return _next_pow2(max(1 << 10, self.estimated_kmers))

    @property
    def pair_cap(self) -> int:
        if self.pair_capacity is not None:
            return _next_pow2(self.pair_capacity)
        return _next_pow2(max(1 << 10, self.estimated_kmers // 16))

    @property
    def shard_bits(self) -> int:
        """log2 of the hash-range shard count. Bloom/table addresses are
        owner-prefixed with this many bits, so global arrays split into
        n_shards equal hash-range-local pieces (SURVEY.md §7.1.3)."""
        return (self.n_shards - 1).bit_length()

    def local_shard(self) -> "Config":
        """Per-shard view of this config: every capacity exactly divided
        by n_shards, addressing unprefixed — used INSIDE shard_map where
        each device holds its own hash-range slice. Local sizes must be
        exact quotients so that concatenating shard-local arrays
        reproduces the global owner-prefixed arrays bit for bit."""
        import dataclasses as _dc

        sb = self.shard_bits
        return _dc.replace(
            self, n_shards=1,
            n_hash_a_override=self.n_hash_a,
            n_hash_b_override=self.n_hash_b,
            n_hash_d_override=self.n_hash_d,
            n_hash_e_override=self.n_hash_e,
            bloom_a_log2_override=self.bloom_a_bits.bit_length() - 1 - sb,
            bloom_b_log2_override=self.bloom_b_bits.bit_length() - 1 - sb,
            bloom_d_log2_override=self.bloom_d_bits.bit_length() - 1 - sb,
            bloom_e_log2_override=self.bloom_e_bits.bit_length() - 1 - sb,
            cascade_cap_a_override=self.cascade_cap_a >> sb,
            cascade_cap_b_override=self.cascade_cap_b >> sb,
            node_cap_d_override=self.node_cap_d >> sb,
            node_cap_e_override=self.node_cap_e >> sb,
            junction_capacity=self.junction_cap >> sb,
            sink_capacity=self.sink_cap >> sb,
            pair_capacity=self.pair_cap >> sb)

    # ---- (de)serialization ---------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(**json.loads(s))
