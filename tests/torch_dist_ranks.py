"""Rank-side helpers of the tests/test_torch_dist_*.py files: each function
runs inside one rank spawned by faucet_tpu_torch.dist.mesh.spawn.

This module imports only torch, numpy and faucet_tpu_torch, so the ranks
start without jax. Inputs are made in each rank from a case's seed with
the port's copy of simulate.py, which gives the reads that
faucet_tpu.simulate gives for the same seed.
"""
import hashlib

import numpy as np
import torch

from faucet_tpu_torch import simulate
from faucet_tpu_torch.config import Config

# (genome, shredding) of each input, as the reference's tests/dist cases
INPUTS = {
    "repeats2024": dict(seed=2024, n=3000, n_repeats=2, repeat_len=200,
                        cov=40, read_len=100),
    "repeats99": dict(seed=99, n=3000, n_repeats=2, repeat_len=200, cov=40,
                      read_len=100),
    "tiny7": dict(seed=7, n=1500, n_repeats=2, repeat_len=100, cov=25,
                  read_len=100),
}

BASE = dict(size_kmer=21, max_read_length=100, batch_reads=64, n_shards=4,
            estimated_kmers=1 << 14, singletons=1 << 14,
            junction_capacity=1 << 13, sink_capacity=1 << 14, fp_rate=0.002)


def reads_of(name):
    """The reads of INPUTS[name], or of the phased repeat ("phased")."""
    if name == "phased":
        return phased_case()[0]
    c = INPUTS[name]
    rng = np.random.default_rng(c["seed"])
    genome = simulate.genome_with_repeats(rng, c["n"], n_repeats=c["n_repeats"],
                                          repeat_len=c["repeat_len"])
    return simulate.shred(rng, genome, coverage=c["cov"],
                          read_len=c["read_len"], circular=True)


def phased_case():
    """tests/dist/test_pairs_sharded.py's phased repeat, interleaved."""
    rng = np.random.default_rng(4242)
    g = lambda n: simulate.random_genome(rng, n)
    p, q, s, t, r = g(40), g(40), g(40), g(40), g(40)
    A, B, C, D = g(60), g(60), g(60), g(60)
    M = [g(220) for _ in range(6)]
    genome = (p + A + r + B + q + M[0] + s + C + r + D + t + M[1]
              + p + M[2] + q + M[3] + s + M[4] + t + M[5])
    m1, m2 = simulate.shred(rng, genome, coverage=60, read_len=80,
                            circular=True, paired=True, insert=250)
    return ([x for ab in zip(m1, m2) for x in ab], (A + r + B, C + r + D),
            (A + r + D, C + r + B))


def np_table(t):
    """A port table as the reference's numpy arrays (TRASH row dropped)."""
    cap = t.capacity
    u32 = lambda a: a[:cap].numpy().view(np.uint32)
    return {"hi": u32(t.keys_hi), "lo": u32(t.keys_lo),
            "vals": [v[:cap].numpy() for v in t.vals]}


def np_cascade(c):
    if c is None:
        return None
    return {"a": c.a_bloom.words.numpy().view(np.uint32),
            "b": c.b_bloom.words.numpy().view(np.uint32),
            "at": np_table(c.a_table), "bt": np_table(c.b_table)}


def contig_keys(g):
    return sorted(g.contigs[i].canonical_seq() for i in g.live())


def run_case(mesh, inp: str, cfg_kw: dict, paired: bool = False,
             cap_factor: float = None, clean: bool = True):
    """Load + scan + build (+ clean) one case on this rank. Returns, on
    rank 0, the global arrays, the raw and cleaned contig keys and the
    metrics; on the other ranks only the contig keys (each rank builds
    the graph)."""
    from faucet_tpu_torch.dist import sharded as SH

    if cap_factor is None:
        return _run_case(mesh, SH, inp, cfg_kw, paired, clean)
    # starve every routing buffer (tests/dist/test_lossless.py:123)
    cap_for = SH._cap_for
    SH._cap_for = lambda n, n_shards, factor=2.0: max(
        32, n // n_shards // cap_factor)
    try:
        return _run_case(mesh, SH, inp, cfg_kw, paired, clean)
    finally:
        SH._cap_for = cap_for


def _run_case(mesh, SH, inp, cfg_kw, paired, clean):
    reads = reads_of(inp)
    sp = SH.ShardedPipeline(Config(**{**BASE, **cfg_kw}), mesh)
    sp.load_reads(reads)
    (sp.scan_paired if paired else sp.scan_reads)(reads)
    pair_counts = sp.pair_counts() if paired else None
    g = sp.build()
    # after build: its prune_slots pass (prune_slot_cov) shows in them
    casc, ncasc, j, s, p = sp.global_state()
    out = {"raw": contig_keys(g)}
    if clean:
        out["clean"] = contig_keys(sp.clean_graph(g))
    if mesh.rank == 0:
        out.update(cascade=np_cascade(casc), node=np_cascade(ncasc),
                   junctions=np_table(j), sinks=np_table(s),
                   pairs=np_table(p), pair_counts=pair_counts,
                   metrics=dict(sp.metrics.counters),
                   collectives=dict(mesh.stats))
    return out


def run_cases(mesh, cases):
    """run_case for each (name, kwargs) in turn, in the same ranks."""
    return {name: run_case(mesh, **kw) for name, kw in cases}


def in_background(fn, *args, **kw):
    """Start fn(*args, **kw) on a thread; the returned callable joins it
    and returns its result (or raises its error). The test process
    computes the reference meanwhile."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:  # re-raised by the joiner
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


def digest(keys) -> str:
    return hashlib.sha256("#".join(keys).encode()).hexdigest()


# ---- route unit cases (tests/test_torch_dist_route.py) ---------------------

ROUTE_N = 512
ROUTE_CAP = 96  # << N: all-to-one skew needs ceil(512 / 96) = 6 rounds
M32 = 0xFFFFFFFF


def route_cases(mesh, owners_seed: int):
    """Every route case on this rank; returns numpy results per case."""
    from faucet_tpu_torch.dist import route as R

    S, N, r = mesh.n_shards, ROUTE_N, mesh.rank
    vals = torch.arange(r * N, (r + 1) * N, dtype=torch.int64)
    ones = torch.ones((N,), dtype=torch.bool)
    out = {}

    def consume(st, recv, rmask):
        # count, sum and an order-sensitive chain over the received lanes
        cnt, tot, chain = st
        v = torch.where(rmask, recv["v"], 0)
        lane = torch.arange(1, v.shape[0] + 1)
        return (cnt + int(rmask.sum()), (tot + int(v.sum())) & M32,
                (chain * 31 + int((v * lane).sum())) & M32)

    for name, owner in (("to3", torch.full((N,), 3)),
                        ("skew", skewed_owners(owners_seed, r, S, N))):
        st, unsent = R.route_consume(mesh, {"v": vals}, owner, ones, S,
                                     ROUTE_CAP, consume, (0, 0, 0))
        got, qun = R.route_query(
            mesh, {"v": vals}, owner, ones, S, ROUTE_CAP,
            lambda recv, rmask: torch.where(rmask, (recv["v"] * 3 + 1) & M32,
                                            0),
            ans_dtype=torch.int64)
        out[name] = {"consume": st, "unsent": int(unsent),
                     "query": got.numpy(), "qunsent": int(qun)}
    # one-shot route of a masked random set: the received layout
    owner, mask = (torch.from_numpy(a)
                   for a in oneshot_items(owners_seed, r, S, N))
    cap = 2 * N // S
    recv, rmask, info = R.route(mesh, {"v": vals, "w": vals[:, None] * 2 +
                                       torch.arange(2)}, owner, mask, S, cap)
    back = R.route_back(mesh, torch.where(rmask, recv["v"] + 7, -1), info,
                        S, cap, fill=-5)
    out["oneshot"] = {"v": recv["v"].numpy(), "w": recv["w"].numpy(),
                      "mask": rmask.numpy(), "back": back.numpy(),
                      "dropped": int(info.dropped)}
    return out


def oneshot_items(seed: int, rank: int, S: int, n: int):
    """(owner, mask) of the one-shot route case."""
    rng = np.random.default_rng(1000 + seed + rank)
    return rng.integers(0, S, n), rng.random(n) < 0.7


def skewed_owners(seed: int, rank: int, S: int, n: int):
    """70% of the items to rank 1, the rest uniform."""
    rng = np.random.default_rng(seed + rank)
    o = np.where(rng.random(n) < 0.7, 1, rng.integers(0, S, n))
    return torch.from_numpy(o.astype(np.int64))


def fail_on(mesh, bad_rank: int, how: str):
    """A rank that raises or dies while the others wait at a collective."""
    import os

    if mesh.rank == bad_rank:
        if how == "raise":
            raise ValueError(f"rank {bad_rank} fails on purpose")
        os._exit(3)
    return mesh.pmax(mesh.rank)


# ---- multi-host (tests/test_torch_dist_cli.py) ------------------------------

MH_CFG = dict(batch_reads=64)


def host_half(reads, host: int, hosts: int = 2, block: int = 32):
    """This host's reads: blocks of `block` reads dealt round-robin
    (tests/dist/test_multihost.py:39)."""
    return [r for i, r in enumerate(reads) if (i // block) % hosts == host]


def digest_rank(mesh, host_reads: bool):
    """Assemble repeats2024 (host_reads: this rank's host's half of it) and
    return the digest of the cleaned contig set."""
    from faucet_tpu_torch.dist.sharded import ShardedPipeline

    reads = reads_of("repeats2024")
    if host_reads:
        reads = host_half(reads, mesh.host, mesh.hosts)
    sp = ShardedPipeline(Config(**{**BASE, **MH_CFG}), mesh)
    sp.load_reads(reads)
    sp.scan_reads(reads)
    assert sp.metrics.counters["route_dropped"] == 0
    g = sp.clean_graph(sp.build())
    keys = contig_keys(g)
    return len(keys), digest(keys)


def host_main(host: int, port: int):
    """One "host" of a two-host run: its 2 ranks of 4, joined over TCP on
    localhost; prints each rank's contig count and digest."""
    from faucet_tpu_torch.dist.mesh import spawn

    for n, d in spawn(digest_rank, 4, args=(True,), threads=1, timeout=300,
                      init_method=f"tcp://localhost:{port}", hosts=2,
                      host=host):
        print(f"RESULT {n} {d}", flush=True)


# ---- tests/test_torch_nojax.py ---------------------------------------------

BANNED = ("jax", "jaxlib", "faucet_tpu")


def nojax_rank(mesh):
    """A rank that assembles a small genome sharded and reports whether
    jax or faucet_tpu is importable (its process was started with them
    blocked) or was imported."""
    import importlib

    from faucet_tpu_torch.dist import halo, swalk  # noqa: F401
    from faucet_tpu_torch.dist.sharded import ShardedPipeline

    rng = np.random.default_rng(3)
    genome = simulate.random_genome(rng, 1500)
    reads = simulate.shred(rng, genome, coverage=30, read_len=80,
                           circular=True)
    cfg = Config(size_kmer=21, max_read_length=80, batch_reads=128,
                 estimated_kmers=1 << 12, singletons=1 << 12,
                 junction_capacity=1 << 10, sink_capacity=1 << 12,
                 n_shards=mesh.n_shards, distributed_clean=True)
    g = ShardedPipeline(cfg, mesh).run_file_mode(reads, reads)
    blocked = []
    for name in BANNED:
        try:
            importlib.import_module(name)
        except ImportError:
            blocked.append(name)
    loaded = [m for m in __import__("sys").modules
              if m.split(".")[0] in BANNED]
    return len(g.live()), blocked, loaded
