"""One short run of a cell on the card, printing the contract's line.
Run on the chip: python -m pytest benchmark/tests/test_bench_chip.py -m cuda
"""
import json
import subprocess
import sys

import pytest

from benchmark import run


@pytest.mark.cuda
def test_short_run_prints_the_contract_line():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "saureus-k55.ingest", "--seed", str(2 ** 35 + 1), "--seconds", "3",
         "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "limits"
    assert line["correct"] is True and line["failed"] == 0
    e2e, _ = run.declared_metrics("saureus-k55.ingest")
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    dev = line["device"]
    assert line["metrics"]["device_peak_gib"]["value"] \
        == dev["memory_peak_bytes"] / 2 ** 30
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
