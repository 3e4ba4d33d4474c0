"""faucet_tpu_torch runs where jax is not installed (the GPU machine), and
imports nothing of faucet_tpu.

A subprocess blocks jax, jaxlib and the faucet_tpu package with a
sys.meta_path finder, imports every module of the port (dist/ included)
and chip_smoke.py, and assembles a small genome on the CPU in each mode:
any import of jax or of faucet_tpu fails. Its sharded run's ranks are
processes of their own: a sitecustomize on their PYTHONPATH installs the
same finder at their start, and each reports that the packages are
blocked and were never imported. A scan of the sources (dist/ included)
rejects import lines of either.
"""
import dataclasses
import os
import re
import subprocess
import sys

import pytest

_BANNED = re.compile(r"(from|import)\s+(jax|jaxlib|faucet_tpu)(\.|\s|,|$)")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "faucet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
for m in [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "faucet_tpu")]:
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
from faucet_tpu_torch import Config
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

# the paired path: two-pass and single-pass, pairs captured and used
# (chip_smoke's phased repeat: mates span junctions on both sides)
import dataclasses
mates = sys.modules["chip_smoke"].phased_case()[0]
pcfg = dataclasses.replace(cfg, paired_ends=True, pair_capacity=1 << 12,
                           estimated_kmers=1 << 15, singletons=1 << 15)
p = Pipeline(pcfg, device="cpu")
p.load_reads(mates)
p.scan_paired(mates)
assert len(p.clean_graph(p.build()).live()) >= 1
assert int(p.pairs.count) > 0 and p.pair_counts()
assert len(Pipeline(pcfg, device="cpu").run_streaming(mates).live()) >= 1

# the k = 55 path (wide codes, ext8 junctions) and ext8 with narrow keys
wcfg = dataclasses.replace(cfg, size_kmer=55)
wp = Pipeline(wcfg, device="cpu")
assert wp.node_cascade is None and wp.jspool is None
assert len(wp.run_file_mode(reads, reads).live()) >= 1
assert int(wp.junctions.count) >= 0 and wp.sinks.vals[-1].shape[1:] == (4,)
assert len(Pipeline(wcfg, device="cpu").run_streaming(reads).live()) >= 1
ecfg = dataclasses.replace(cfg, junction_detect="ext8")
assert len(Pipeline(ecfg, device="cpu").run_file_mode(reads, reads).live())
# exact mode with the prune_slots pre-clean, and dual-k's chunks
assert "faucet_tpu_torch.dist.sharded" in names
from faucet_tpu_torch.pipeline import contig_chunks
xcfg = dataclasses.replace(cfg, exact=True, prune_slot_cov=2)
xg = Pipeline(xcfg, device="cpu").run_file_mode(reads, reads)
assert len(xg.live()) >= 1 and contig_chunks(xg, 80, 31)
from faucet_tpu_torch.core import wide as WD
assert WD.decode_kmer_wide(WD.encode_kmer_wide("ACGT" * 14 + "A"),
                           57) == "ACGT" * 14 + "A"

# the new kernel modules' plain versions
from faucet_tpu_torch.core import scan as SC
from faucet_tpu_torch.kernels import bloom_scatter as KS
from faucet_tpu_torch.kernels import compact as KCP
w = torch.zeros(64, dtype=torch.int32)
ks = torch.tensor([0, 3, 0xFFFFFFFF])
assert KS.bloom_insert_codes(w, ks, ks + 5, ks >= 0, 3, 11).any()
assert KS.scatter_or_bits(w.clone().zero_(), ks).sum() != 0
mask = torch.arange(50) % 3 == 0
idx, cnt = KCP.mask_indices(mask, 8)
assert int(cnt) == 17 and idx.tolist() == list(range(0, 24, 3))
state, total = SC.compact_rounds(mask, 8, (torch.arange(50),),
                                 lambda s, cm, ps: s + ps[0][cm].sum(), 0,
                                 KCP.mask_indices_plain)
assert total == 17 and int(state) == int(torch.arange(50)[mask].sum())
assert not any(m.split(".")[0] in ("jax", "jaxlib", "faucet_tpu")
               for m in sys.modules)

# dist/: two gloo ranks, spawned with the finder installed at their start
for n in ("mesh", "route", "sharded", "swalk", "halo"):
    assert f"faucet_tpu_torch.dist.{n}" in names
import torch_dist_ranks as DR
from faucet_tpu_torch.dist.mesh import spawn
for n_contigs, blocked, loaded in spawn(DR.nojax_rank, 2, threads=1,
                                        timeout=200):
    assert n_contigs >= 1
    assert sorted(blocked) == sorted(DR.BANNED) and not loaded, (blocked,
                                                                 loaded)
print("OK", len(names))
'''

_SITE = '''
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "faucet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
'''


def test_port_imports_and_runs_without_jax(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(_SITE)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tmp_path), _REPO, os.path.join(_REPO, "tests"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK"), r.stdout
    assert int(r.stdout.split()[1]) >= 20  # every module was walked


def test_no_jax_or_faucet_tpu_import_in_sources():
    pkg = os.path.join(_REPO, "faucet_tpu_torch")
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    hits = []
    for p in paths:
        for i, line in enumerate(open(p), 1):
            if _BANNED.match(line.strip()):
                hits.append(f"{p}:{i}")
    assert len(paths) >= 20 and not hits, hits


_CFG_CASES = [
    dict(size_kmer=31),
    dict(size_kmer=21, estimated_kmers=1 << 20, singletons=1 << 22,
         fp_rate=0.002, paired_ends=True),
    dict(size_kmer=27, junction_detect="ext8", two_hash=True),
    dict(size_kmer=31, exact=True, n_shards=2),
]


@pytest.mark.parametrize("kw", _CFG_CASES)
def test_config_copy_and_checkpoint_hash_match_the_reference(kw):
    """The port's Config (a copy) derives the same values as the
    reference's from the same arguments, and the checkpoint guard hashes
    both alike, so checkpoints keep loading both ways."""
    from faucet_tpu.ckpt.state import _cfg_hash as jhash
    from faucet_tpu.config import Config as JConfig
    from faucet_tpu_torch import Config as TConfig
    from faucet_tpu_torch.ckpt.state import _cfg_hash as thash

    jc, tc = JConfig(**kw), TConfig(**kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for name in ("n_hash_a", "n_hash_b", "bloom_a_bits", "bloom_b_bits",
                 "use_node_junctions", "junction_cap", "sink_cap"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert thash(tc) == thash(jc) == jhash(jc) == jhash(tc)
    assert dataclasses.asdict(tc.node_view()) == \
        dataclasses.asdict(jc.node_view())
