"""Ranks and collectives for hash-range sharding (port of
faucet_tpu/dist/mesh.py).

The reference drives n devices from one process through a 1-D jax Mesh
and `shard_map`. Here every shard is one process (a rank) of a
`torch.distributed` process group: its kernels, scratch and launch
counters are its own, and it blocks at every collective, which the
shard bodies' data-dependent round loops need (a round count is agreed
by a max over the ranks before the loop, so every rank issues the same
collectives).

`Mesh` is one rank's view: `n_shards`, its `rank`, its `device`, the
backend, and the collectives the shard bodies use — `all_to_all` over a
[n_shards, cap, ...] buffer (the layout of `lax.all_to_all(split_axis=0,
concat_axis=0, tiled=False)`), `pmax`/`psum` of host scalars, and `fetch`,
the rank-ordered gather of a shard-local tensor into the global array.

The backend is the caller's choice, never swapped on an error: `nccl`
when each rank has a GPU of its own, `gloo` when ranks share a device or
run on the CPU (NCCL refuses two ranks on one device). gloo exchanges
host tensors, so a gloo rank on a CUDA device copies each buffer to host
memory, exchanges it and copies it back.

`spawn` starts the ranks: one process per rank with the `spawn` start
method (CUDA needs it), the group's store in a file under a fresh
temporary directory (no fixed TCP port), a timeout on the group and on
every wait. A rank that raises, hangs or dies fails the caller with its
traceback, and the other ranks are stopped.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

def check_n_shards(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"n_shards must be a power of two, got {n}")
    return n


class Mesh:
    """One rank of an n_shards-rank process group.

    hosts / host / local: the feeding layout (multi-host runs): `hosts`
    processes each feed their own reads to their `n_shards // hosts`
    ranks, and this rank is local rank `local` of host `host`."""

    def __init__(self, n_shards: int, rank: int, device, backend: str,
                 hosts: int = 1, group=None):
        self.n_shards = check_n_shards(n_shards)
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        self.hosts = hosts
        self.per_host = n_shards // hosts
        self.host, self.local = divmod(rank, self.per_host)
        # where exchanges happen: gloo moves host tensors only (a gloo
        # rank on a card stages each buffer through host memory)
        self.comm_device = (torch.device("cpu") if backend == "gloo"
                            else self.device)
        # collectives made, all_to_all bytes sent and seconds (host
        # staging included), extra lossless-carry rounds of routes
        self.stats = {"all_to_all": 0, "all_to_all_bytes": 0,
                      "all_to_all_s": 0.0, "reduce": 0, "gather": 0,
                      "carry_rounds": 0}

    # ---- collectives ----------------------------------------------------
    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """buf [n_shards, ...]: block j goes to rank j; the result's block
        j is what rank j sent here. On gloo, as point-to-point sends and
        receives posted on the process group all at once (the
        ProcessGroup's own send/recv, without the Python wrappers'
        per-call cost): for the small buffers of a routed walk step they
        finish sooner than gloo's all_to_all."""
        t0 = time.perf_counter()
        x = buf.contiguous().to(self.comm_device)
        out = torch.empty_like(x)
        if self.backend == "gloo" and self.n_shards > 1:
            pg = self.group or dist.group.WORLD
            out[self.rank] = x[self.rank]
            works = [w for j in range(self.n_shards) if j != self.rank
                     for w in (pg.send([x[j]], j, 0),
                               pg.recv([out[j]], j, 0))]
            for w in works:
                w.wait()
        else:
            dist.all_to_all_single(out, x, group=self.group)
        out = out.to(buf.device)
        st = self.stats
        st["all_to_all"] += 1
        st["all_to_all_bytes"] += x.numel() * x.element_size()
        st["all_to_all_s"] += time.perf_counter() - t0
        return out

    def _reduce(self, vals, op):
        self.stats["reduce"] += 1
        t = torch.tensor(vals, device=self.comm_device)
        dist.all_reduce(t, op=op, group=self.group)
        return t.tolist()

    def pmax(self, v: int) -> int:
        return int(self._reduce([int(v)], dist.ReduceOp.MAX)[0])

    def pmax_many(self, vals: Sequence[int]) -> List[int]:
        return [int(x) for x in self._reduce([int(v) for v in vals],
                                             dist.ReduceOp.MAX)]

    def psum(self, v):
        return self._reduce([v], dist.ReduceOp.SUM)[0]

    def psum_many(self, vals: Sequence):
        return self._reduce(list(vals), dist.ReduceOp.SUM)

    def fetch(self, t: torch.Tensor) -> torch.Tensor:
        """Rank-ordered concatenation along dim 0 of every rank's `t`
        (same shape on every rank), on this rank's device."""
        self.stats["gather"] += 1
        x = t.contiguous().to(self.comm_device)
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts).to(t.device)

    def fetch_rows(self, t: torch.Tensor) -> torch.Tensor:
        """fetch for tensors whose dim 0 differs across ranks."""
        n = t.shape[0]
        counts = self.gather_ints(n)
        pad = torch.zeros((max(counts),) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        pad[:n] = t
        g = self.fetch(pad).reshape((self.n_shards, max(counts))
                                    + t.shape[1:])
        return torch.cat([g[r, :c] for r, c in enumerate(counts)])

    def gather_ints(self, n: int) -> List[int]:
        """Every rank's n, in rank order."""
        self.stats["gather"] += 1
        x = torch.tensor([int(n)], device=self.comm_device)
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        dist.all_gather(parts, x, group=self.group)
        return [int(p) for p in parts]

    def barrier(self):
        # an all_reduce rather than dist.barrier: NCCL's barrier needs the
        # rank's device bound to the group
        self.psum(0)


def usable_cpus() -> int:
    """CPUs this process may run on: its affinity, capped by a cgroup v2
    CPU quota where one is set (os.cpu_count() sees neither)."""
    n = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
         else os.cpu_count() or 1)
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        if quota != "max":
            n = min(n, max(1, int(quota) // int(period)))
    except (OSError, ValueError):
        pass
    return n


def default_backend(devices: Sequence) -> str:
    """nccl when every rank has a CUDA device of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def _worker(rank: int, n_shards: int, hosts: int, init: str, backend: str,
            device: str, threads: Optional[int], timeout_s: float,
            fn: Callable, args: tuple, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init, world_size=n_shards, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = Mesh(n_shards, rank, dev, backend, hosts=hosts)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n_shards: int, args: tuple = (),
          devices: Optional[Sequence] = None, backend: str = "gloo",
          timeout: float = 600.0, threads: Optional[int] = None,
          init_method: Optional[str] = None, hosts: int = 1,
          host: int = 0) -> List:
    """Run fn(mesh, *args) in one process per rank and return the ranks'
    results in rank order (each must pickle).

    devices: one per local rank (default: all "cpu"). With hosts > 1 this
    process starts only its n_shards // hosts ranks (global ranks
    host * local + i) and `init_method` (tcp://host:port) joins them to
    the other hosts' ranks. Raises RuntimeError, with the failing rank's
    traceback, when a rank raises, dies, or the whole run outlasts
    `timeout` seconds; every started rank is stopped before it returns."""
    import torch.multiprocessing as mp

    check_n_shards(n_shards)
    if n_shards % hosts:
        raise ValueError(f"{n_shards} shards do not split over {hosts} "
                         "hosts")
    local = n_shards // hosts
    devices = list(devices) if devices is not None else ["cpu"] * local
    if len(devices) != local:
        raise ValueError(f"need {local} devices, got {len(devices)}")
    if any(torch.device(d).type == "cuda" for d in devices):
        # one nvcc build in the parent: the ranks load the same library
        from faucet_tpu_torch.kernels import build as KB

        KB.build()
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="faucet_tpu_torch_group_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = []
    try:
        for i in range(local):
            rank = host * local + i
            p = ctx.Process(
                target=_worker, daemon=True,
                args=(rank, n_shards, hosts, init_method, backend,
                      str(devices[i]), threads, timeout, fn, args, results))
            p.start()
            procs.append((rank, p))
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < local:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"ranks {sorted(set(r for r, _ in procs) - set(out))} "
                    f"did not finish within {timeout:.0f} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in procs
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank that posted its result may still be flushing
                    # it through the queue: look once more before failing
                    try:
                        rank, ok, val = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0][0]} died (exit code "
                            f"{dead[0][1]}) without a result") from None
                else:
                    continue
            if not ok:
                # one failure makes the others fail at their next
                # collective: report every failure and death seen within
                # a moment, the first cause among them
                fails = [(rank, val)]
                time.sleep(0.5)
                while True:
                    try:
                        r, ok2, v = results.get(timeout=0.1)
                    except queue.Empty:
                        break
                    if not ok2:
                        fails.append((r, v))
                dead = [(r, p.exitcode) for r, p in procs
                        if r not in out and p.exitcode not in (None, 0)]
                raise RuntimeError("".join(
                    [f"rank {r} died (exit code {c})\n" for r, c in dead]
                    + [f"rank {r} failed:\n{v}" for r, v in fails]))
            out[rank] = val
        for _, p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[host * local + i] for i in range(local)]
    finally:
        for _, p in procs:
            if p.is_alive():
                p.terminate()
        for _, p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
