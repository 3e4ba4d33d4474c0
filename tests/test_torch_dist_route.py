"""dist/route.py's lossless all_to_all routing on 4 gloo ranks against the
reference's route.py inside shard_map on a 4-device CPU mesh (ports of
tests/dist/test_lossless.py:46, :72 and :100), and dist/mesh.py's rank
start-up failing fast.

Routes: everything sent to one owner (6 carry rounds at cap 96), a skewed
owner mix (several rounds), and a one-shot route of a masked random set:
per rank, the received layout (payload and mask, lane for lane), the
answers returned by route_back, consume's order-sensitive fold over the
rounds and n_unsent must equal the reference's. The single-device scan
with a tiny scan_update_cap keeps the table content (lossless rounds).
The ranks' threads are shared out from the usable CPUs.
"""
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from faucet_tpu.dist import route as JR
from faucet_tpu.dist.mesh import AXIS, make_mesh
from faucet_tpu_torch.config import Config as TConfig
from faucet_tpu_torch.dist.mesh import spawn, usable_cpus
from faucet_tpu_torch.pipeline import Pipeline as TPipeline

import torch_dist_ranks as DR
from torch_dist_ref import content

torch.set_num_threads(1)

S = 4
N, CAP = DR.ROUTE_N, DR.ROUTE_CAP
SEED = 5


@pytest.fixture(scope="module")
def ranks():
    return spawn(DR.route_cases, S, args=(SEED,), threads=1, timeout=120)


def _ref_case(owner_of):
    """Reference consume fold, query answers and unsent per shard."""
    mesh = make_mesh(S)

    def body(vals, owner):
        ones = jnp.ones((N,), bool)

        def consume(st, recv, rmask):
            cnt, tot, chain = st
            v = jnp.where(rmask, recv["v"], 0)
            lane = jnp.arange(1, v.shape[0] + 1, dtype=jnp.uint32)
            return (cnt + jnp.sum(rmask, dtype=jnp.int32),
                    tot + jnp.sum(v, dtype=jnp.uint32),
                    chain * jnp.uint32(31) + jnp.sum(v * lane,
                                                     dtype=jnp.uint32))

        (cnt, tot, chain), un = JR.route_consume(
            {"v": vals}, owner, ones, S, CAP, consume,
            (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.uint32),
             jnp.zeros((), jnp.uint32)))
        got, qun = JR.route_query(
            {"v": vals}, owner, ones, S, CAP,
            lambda recv, rmask: jnp.where(
                rmask, recv["v"] * jnp.uint32(3) + jnp.uint32(1), 0),
            ans_dtype=jnp.uint32)
        return (cnt.reshape(1), tot.reshape(1), chain.reshape(1),
                un.reshape(1), got, qun.reshape(1))

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
                          out_specs=(P(AXIS),) * 6, check_vma=False))
    vals = jnp.arange(S * N, dtype=jnp.uint32)
    owner = jnp.asarray(np.concatenate([owner_of(r) for r in range(S)]),
                        jnp.int32)
    return [np.asarray(x) for x in f(vals, owner)]


@pytest.mark.parametrize("name", ["to3", "skew"])
def test_route_consume_and_query_lossless(ranks, name):
    owner_of = {"to3": lambda r: np.full(N, 3),
                "skew": lambda r: DR.skewed_owners(SEED, r, S, N).numpy()
                }[name]
    cnt, tot, chain, un, got, qun = _ref_case(owner_of)
    assert un.sum() == 0 and qun.sum() == 0
    assert cnt.sum() == S * N
    for r in range(S):
        mine = ranks[r][name]
        assert mine["consume"] == (int(cnt[r]), int(tot[r]), int(chain[r]))
        assert mine["unsent"] == 0 and mine["qunsent"] == 0
        np.testing.assert_array_equal(mine["query"],
                                      got[r * N:(r + 1) * N].astype(np.int64))
    if name == "to3":
        assert ranks[3][name]["consume"][0] == S * N


def test_route_oneshot_layout_and_route_back(ranks):
    mesh = make_mesh(S)
    cap = 2 * N // S

    def body(vals, owner, mask):
        w = vals[:, None] * 2 + jnp.arange(2, dtype=jnp.int32)
        recv, rmask, info = JR.route({"v": vals, "w": w}, owner, mask, S,
                                     cap)
        back = JR.route_back(jnp.where(rmask, recv["v"] + 7, -1), info, S,
                             cap, fill=-5)
        return recv["v"], recv["w"], rmask, back, info.dropped.reshape(1)

    f = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=(P(AXIS), P(AXIS), P(AXIS)),
                          out_specs=(P(AXIS),) * 5, check_vma=False))
    items = [DR.oneshot_items(SEED, r, S, N) for r in range(S)]
    v, w, m, back, dropped = (np.asarray(x) for x in f(
        jnp.arange(S * N, dtype=jnp.int32),
        jnp.asarray(np.concatenate([o for o, _ in items]), jnp.int32),
        jnp.asarray(np.concatenate([k for _, k in items]))))
    L = S * cap
    for r in range(S):
        mine = ranks[r]["oneshot"]
        sl = slice(r * L, (r + 1) * L)
        np.testing.assert_array_equal(mine["mask"], m[sl])
        np.testing.assert_array_equal(mine["v"], v[sl])
        np.testing.assert_array_equal(mine["w"], w[sl])
        np.testing.assert_array_equal(mine["back"], back[r * N:(r + 1) * N])
        assert mine["dropped"] == int(dropped[r])


def test_scan_update_cap_rounds_lossless():
    """A tiny scan_update_cap changes nothing in the tables' content
    (tests/dist/test_lossless.py:100, the port's single-device scan)."""
    reads = DR.reads_of("tiny7")
    base = dict(size_kmer=21, max_read_length=100, batch_reads=128,
                exact=True, estimated_kmers=1 << 13, singletons=1 << 13,
                junction_capacity=1 << 12, sink_capacity=1 << 13)
    out = []
    for cap in (64, 1 << 13):
        p = TPipeline(TConfig(scan_update_cap=cap, **base), device="cpu")
        p.load_reads(reads)
        p.scan_reads(reads)
        out.append(p)
    a, b = (dict(DR.np_table(p.junctions)) for p in out)
    assert content(a) == content(b) and len(content(a)) > 0
    assert content(DR.np_table(out[0].sinks)) == \
        content(DR.np_table(out[1].sinks))
    assert int(out[0].sinks.dropped) == 0


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_failing_rank_fails_the_caller(how):
    """A rank that raises (traceback relayed) or dies makes spawn raise,
    well inside its timeout, while the other ranks wait at a collective
    (a dead rank is named as the cause of its peers' errors)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="fails on purpose" if how == "raise"
                       else "rank 2 died"):
        spawn(DR.fail_on, S, args=(2, how), threads=1, timeout=60)
    assert time.monotonic() - t0 < 50


def test_usable_cpus_within_affinity():
    """The CPUs the ranks' threads are shared out from: at least one, and
    no more than the process may run on."""
    n = usable_cpus()
    assert 1 <= n <= len(os.sched_getaffinity(0)) <= os.cpu_count()
