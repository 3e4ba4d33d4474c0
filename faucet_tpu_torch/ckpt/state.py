"""Checkpoint / resume of the post-scan stream state, plus converters
between the reference's state and the port's.

Port of faucet_tpu/ckpt/state.py with the same npz layout and config hash,
so either package resumes from the other's checkpoint. On disk, words and
keys are uint32, junction dist8 is uint16, the wide tables' code-word
column is uint32 and count/dropped are int32 scalars, exactly as the
reference writes them; in memory the port keeps int32 bit patterns, int32
dist8, the code words as int64 (so a "max" combine keeps their unsigned
order) and a trailing TRASH row per table (core/table.py).

The *_from_numpy / *_to_numpy functions are the in-memory form of the same
mapping: they take the reference's state (its NamedTuples, or anything
whose fields np.asarray accepts) and return the port's, and back.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from faucet_tpu_torch.config import Config
from faucet_tpu_torch.core import bloom as BL
from faucet_tpu_torch.core import scan as SC
from faucet_tpu_torch.core import table as T
from faucet_tpu_torch.device import resolve_device


def _cfg_hash(cfg: Config) -> str:
    # identical to the reference's: only semantics-affecting fields guard
    # the checkpoint, including the resolved junction mode and the
    # effective per-filter hash counts
    keys = ("size_kmer", "estimated_kmers", "singletons", "fp_rate",
            "two_hash", "exact", "n_shards")
    d = {k: getattr(cfg, k) for k in keys}
    d["use_node_junctions"] = cfg.use_node_junctions
    d["n_hash"] = (cfg.n_hash_a, cfg.n_hash_b)
    if cfg.use_node_junctions:
        d["n_hash_nodes"] = (cfg.n_hash_d, cfg.n_hash_e)
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()


# ---- converters ----------------------------------------------------------

def words_from_numpy(a, device=None) -> torch.Tensor:
    """uint32 numpy words -> int32 bit-pattern tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(
        np.int32).copy()).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32).copy()


def table_from_numpy(t, device=None) -> T.Table:
    """Reference Table (keys_hi, keys_lo, vals, count, dropped) -> port."""
    def keys(a):
        return words_from_numpy(np.concatenate(
            [np.asarray(a, np.uint32), np.full(1, 0xFFFFFFFF, np.uint32)]),
            device)

    def val(a):
        a = np.asarray(a)
        # uint32 values (the wide code words) as int64, the rest as int32
        a = a.astype(np.int64 if a.dtype == np.uint32 else np.int32)
        a = np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)])
        return torch.from_numpy(a).to(device)

    # a sharded reference run keeps one counter per shard: their sum
    scalar = lambda a: torch.tensor(int(np.asarray(a).sum()),
                                    dtype=torch.int64, device=device)
    return T.Table(keys_hi=keys(t.keys_hi), keys_lo=keys(t.keys_lo),
                   vals=tuple(val(v) for v in t.vals),
                   count=scalar(t.count), dropped=scalar(t.dropped))


def table_to_numpy(t: T.Table, val_dtypes: Optional[Sequence] = None
                   ) -> Dict[str, object]:
    """Port Table -> dict of numpy arrays in the reference's layout
    (TRASH row dropped). val_dtypes: numpy dtypes of the first value
    arrays (the junction table's dist8 is uint16 in the reference); the
    rest are uint32 when held as int64 (code words), else int32."""
    cap = t.capacity
    dts = list(val_dtypes or ()) + [
        np.uint32 if v.dtype == torch.int64 else np.int32
        for v in t.vals[len(val_dtypes or ()):]]
    return {"keys_hi": words_to_numpy(t.keys_hi[:cap]),
            "keys_lo": words_to_numpy(t.keys_lo[:cap]),
            "vals": tuple(v[:cap].cpu().numpy().astype(d)
                          for v, d in zip(t.vals, dts)),
            # a sharded run's global table counts per shard, [n_shards]
            "count": t.count.cpu().numpy().astype(np.int32),
            "dropped": t.dropped.cpu().numpy().astype(np.int32)}


def cascade_from_numpy(c, device=None) -> BL.Cascade:
    """Reference Cascade (a_bloom.words, b_bloom.words, a_table,
    b_table) -> port Cascade."""
    return BL.Cascade(
        a_bloom=BL.Bloom(words_from_numpy(c.a_bloom.words, device)),
        b_bloom=BL.Bloom(words_from_numpy(c.b_bloom.words, device)),
        a_table=table_from_numpy(c.a_table, device),
        b_table=table_from_numpy(c.b_table, device))


def cascade_to_numpy(c: BL.Cascade) -> Dict[str, object]:
    return {"a_words": words_to_numpy(c.a_bloom.words),
            "b_words": words_to_numpy(c.b_bloom.words),
            "a_table": table_to_numpy(c.a_table),
            "b_table": table_to_numpy(c.b_table)}


def spool_from_numpy(s, device=None) -> SC.JSpool:
    """Reference JSpool (khi, klo, sf, dd uint32[S], cnt) -> port."""
    w = lambda a: words_from_numpy(a, device)
    return SC.JSpool(khi=w(s.khi), klo=w(s.klo), sf=w(s.sf), dd=w(s.dd),
                     cnt=int(np.asarray(s.cnt)))


def spool_to_numpy(s: SC.JSpool) -> Dict[str, object]:
    return {"khi": words_to_numpy(s.khi), "klo": words_to_numpy(s.klo),
            "sf": words_to_numpy(s.sf), "dd": words_to_numpy(s.dd),
            "cnt": np.int32(s.cnt)}


# ---- npz checkpoints -------------------------------------------------------

def _table_arrays(prefix: str, tbl: T.Table, val_dtypes=None):
    d = table_to_numpy(tbl, val_dtypes)
    out = {f"{prefix}_keys_hi": d["keys_hi"],
           f"{prefix}_keys_lo": d["keys_lo"],
           f"{prefix}_count": d["count"],
           f"{prefix}_dropped": d["dropped"]}
    for i, v in enumerate(d["vals"]):
        out[f"{prefix}_val{i}"] = v
    return out


class _NpzTable:
    """A checkpoint table's arrays in table_from_numpy's field names."""

    def __init__(self, prefix: str, z):
        self.keys_hi = z[f"{prefix}_keys_hi"]
        self.keys_lo = z[f"{prefix}_keys_lo"]
        n_vals = 0
        while f"{prefix}_val{n_vals}" in z:
            n_vals += 1
        self.vals = tuple(z[f"{prefix}_val{i}"] for i in range(n_vals))
        self.count = z[f"{prefix}_count"]
        self.dropped = z[f"{prefix}_dropped"]


def _table_from(prefix: str, z, device) -> T.Table:
    return table_from_numpy(_NpzTable(prefix, z), device)


def save_bloom(path: str, cfg: Config, cascade: BL.Cascade,
               node_cascade: BL.Cascade = None):
    extra = {}
    if node_cascade is not None:
        extra = dict(nd_words=words_to_numpy(node_cascade.a_bloom.words),
                     ne_words=words_to_numpy(node_cascade.b_bloom.words),
                     **_table_arrays("ndt", node_cascade.a_table),
                     **_table_arrays("net", node_cascade.b_table))
    np.savez_compressed(
        path, cfg_hash=np.frombuffer(_cfg_hash(cfg).encode(), np.uint8),
        a_words=words_to_numpy(cascade.a_bloom.words),
        b_words=words_to_numpy(cascade.b_bloom.words),
        **_table_arrays("at", cascade.a_table),
        **_table_arrays("bt", cascade.b_table), **extra)


def load_bloom(path: str, cfg: Config, device="cuda"):
    """Returns (cascade, node_cascade-or-None) on `device` (cuda unless
    the caller asks for the CPU; without a card a cuda request raises)."""
    device = resolve_device(device)
    z = np.load(path)
    _check(z, cfg, path)

    def cascade(a, b, at, bt):
        return BL.Cascade(a_bloom=BL.Bloom(words_from_numpy(z[a], device)),
                          b_bloom=BL.Bloom(words_from_numpy(z[b], device)),
                          a_table=_table_from(at, z, device),
                          b_table=_table_from(bt, z, device))

    node_cascade = None
    if "nd_words" in z:
        node_cascade = cascade("nd_words", "ne_words", "ndt", "net")
    elif cfg.use_node_junctions:
        # a nodes-mode scan against an empty node cascade would detect
        # zero junctions and silently emit wrong contigs
        raise ValueError(
            f"checkpoint {path} has no branch-node cascade but this run "
            "resolves junction_detect=nodes; rebuild the checkpoint")
    return cascade("a_words", "b_words", "at", "bt"), node_cascade


def save_junctions(path: str, cfg: Config, junctions: T.Table,
                   sinks: T.Table, pairs: T.Table = None):
    """The junction and sink tables, plus the pair table of a paired-end
    run (`p_`-prefixed, as the reference writes it)."""
    extra = _table_arrays("p", pairs) if pairs is not None else {}
    np.savez_compressed(
        path, cfg_hash=np.frombuffer(_cfg_hash(cfg).encode(), np.uint8),
        **_table_arrays("j", junctions, (np.int32, np.uint16)),
        **_table_arrays("s", sinks), **extra)


def load_junctions(path: str, cfg: Config, device="cuda"):
    """Returns (junctions, sinks, pairs-or-None) on `device`, as
    load_bloom. The pair table rides in the junction checkpoint so a
    paired-end resume keeps its disentangle evidence."""
    device = resolve_device(device)
    z = np.load(path)
    _check(z, cfg, path)
    pairs = _table_from("p", z, device) if "p_keys_hi" in z else None
    return _table_from("j", z, device), _table_from("s", z, device), pairs


def _check(z, cfg: Config, path: str):
    want = _cfg_hash(cfg)
    got = bytes(z["cfg_hash"]).decode()
    if got != want:
        raise ValueError(
            f"checkpoint {path} was written with different k-mer/filter "
            f"parameters (hash {got[:12]} != {want[:12]}); refusing to "
            "resume")
