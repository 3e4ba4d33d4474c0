"""The sizing rule of a configuration, and the filter sizes it implies.

`program_kwargs` is chip_smoke.py's `scale_config` (bench/scale_run.py's
rule): the Bloom cascade and the tables are sized from the genome length,
the read count, k and the error rate. The filter arithmetic below it
(`filters`) is copied from faucet_tpu_torch/config.py (`bloom_bits`,
`_min_hashes`, `_node_bits`, `_min_hashes_at` and the node-cascade item
counts), so the plain reference works out the sizes of the filters it
rebuilds without asking the program.
"""
from __future__ import annotations

import math


def program_kwargs(cfg: dict, n_reads: int) -> dict:
    """Keyword arguments of faucet_tpu_torch.Config for a configuration."""
    k, L = cfg["k"], cfg["read_len"]
    n_kmers = cfg["genome_len"] - k + 1
    return dict(size_kmer=k, max_read_length=L,
                batch_reads=cfg["batch_reads"], estimated_kmers=n_kmers,
                singletons=int(n_reads * L * cfg["err_rate"] * k) + n_kmers,
                junction_capacity=1 << 20, sink_capacity=4 * n_kmers,
                fp_rate=cfg["fp_rate"],
                junction_detect=cfg["junction_detect"])


def _next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())


def _bloom_bits(n_items: int, fp: float) -> int:
    bits = int(-n_items * math.log(fp) / (math.log(2) ** 2))
    return _next_pow2(max(bits, 1 << 16))


def _min_hashes(m_bits: int, n_items: int, fp: float) -> int:
    n_eff = max(1, int(1.25 * n_items))
    for h in range(1, 17):
        if (1 - math.exp(-h * n_eff / m_bits)) ** h <= fp:
            return h
    return max(1, round(-math.log2(fp)))


def _node_bits(n_items: int, fp: float) -> int:
    per_key = 3.0 / -math.log1p(-fp ** (1 / 3))
    return _next_pow2(max(int(1.25 * n_items * per_key), 1 << 16))


def filters(kw: dict) -> dict:
    """{name: (log2 bits, n_hash)} of filters A and B, and of the
    branch-node cascade's D and E where k <= 31 runs in nodes mode."""
    est, fp = kw["estimated_kmers"], kw["fp_rate"]
    a_bits = _bloom_bits(est + kw["singletons"], fp)
    b_bits = _bloom_bits(est, fp)
    out = {"a": (a_bits.bit_length() - 1,
                 _min_hashes(a_bits, est + kw["singletons"], fp)),
           "b": (b_bits.bit_length() - 1, _min_hashes(b_bits, est, fp))}
    if uses_nodes(kw):
        nfp = min(fp, 0.002)
        for name, items in (("d", 2 * est), ("e", max(est // 2, 1 << 14))):
            bits = _node_bits(items, nfp)
            out[name] = (bits.bit_length() - 1,
                         _min_hashes(bits, items, nfp))
    return out


def uses_nodes(kw: dict) -> bool:
    """Branch-node junctions: junction_detect nodes, or auto at k <= 31."""
    mode = kw.get("junction_detect", "auto")
    return mode == "nodes" or (mode == "auto" and kw["size_kmer"] <= 31)
