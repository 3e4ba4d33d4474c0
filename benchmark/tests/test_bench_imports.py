"""Nothing the benchmark runs imports jax, faucet_tpu or bench/, compared
by whole top-level module names (faucet_tpu_torch is the port)."""
import ast
import os
import subprocess
import sys

from benchmark import run

BANNED = set(run.BANNED)


def test_sources_import_none_of_them():
    for d, _, files in os.walk(run.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in BANNED, (f, n)


def test_a_run_loads_none_of_them():
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from benchmark import run\n"
        "from benchmark.tests.helpers import tiny\n"
        "for cell in ('saureus-k55.ingest', 'ecoli-k31.assemble'):\n"
        "    run.run_cell(tiny(cell, genome_len=6000), 3, 0.1, False,\n"
        "                 device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "faucet_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & BANNED, loaded & BANNED
