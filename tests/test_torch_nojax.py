"""faucet_tpu_torch runs where jax is not installed (the GPU machine).

A subprocess blocks jax and jaxlib with a sys.meta_path finder, imports
every module of the package and chip_smoke.py, and assembles a small
genome on the CPU: any import of jax, direct or through faucet_tpu, fails.
"""
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[m]

import torch
torch.set_num_threads(1)

import faucet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(faucet_tpu_torch.__path__,
                                               "faucet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
importlib.import_module("chip_smoke")

import numpy as np
from faucet_tpu.config import Config
from faucet_tpu_torch import simulate
from faucet_tpu_torch.pipeline import Pipeline

rng = np.random.default_rng(3)
genome = simulate.random_genome(rng, 1500)
reads = simulate.shred(rng, genome, coverage=30, read_len=80,
                       circular=True)
cfg = Config(size_kmer=21, max_read_length=80, batch_reads=128,
             estimated_kmers=1 << 12, singletons=1 << 12,
             junction_capacity=1 << 10, sink_capacity=1 << 12)
g = Pipeline(cfg, device="cpu").run_file_mode(reads, reads)
assert len(g.live()) >= 1
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print("OK", len(names))
'''


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK"), r.stdout
    assert int(r.stdout.split()[1]) >= 20  # every module was walked


def test_no_jax_import_in_sources():
    pkg = os.path.join(_REPO, "faucet_tpu_torch")
    hits = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(root, f)
                for i, line in enumerate(open(p), 1):
                    s = line.strip()
                    if s.startswith(("import jax", "from jax")):
                        hits.append(f"{p}:{i}")
    assert not hits, hits
