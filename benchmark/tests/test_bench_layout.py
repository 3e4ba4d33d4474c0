"""The benchmark is driven by data: BENCHMARK.json's cells, configs and
per-layer metrics are files found by name, and a new configuration and
workload file run without any edit of the harness."""
import json
import os
import re
import shutil

from benchmark import run

from benchmark.tests.helpers import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_entry_has_its_file():
    b = _bench()
    for c in b["configs"]:
        with open(os.path.join(run.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        spec = run.load_spec(w["name"])
        assert spec["workload"]["config"] == w["config"]
        assert spec["workload"]["traffic"] == w["traffic"]
        assert spec["workload"]["chips"] == w["chips"] == 1
        assert spec["workload"]["passes"] in run.DRIVERS
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {m["moves"] for m in b["per_layer"]} <= e2e


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in _bench()["workloads"]:
        e2e, per_layer = run.declared_metrics(w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        assert {m["moves"] for m in per_layer} <= names


def test_a_new_config_and_workload_run_without_an_edit(tmp_path):
    for d in ("configs", "workloads"):
        shutil.copytree(os.path.join(run.HERE, d), tmp_path / d)
    cfg = json.loads((tmp_path / "configs" / "ecoli-k31.json").read_text())
    cfg.update(name="tiny-k21", k=21, genome_len=8000)
    (tmp_path / "configs" / "tiny-k21.json").write_text(json.dumps(cfg))
    (tmp_path / "workloads" / "tiny-k21.ingest.json").write_text(json.dumps(
        {"config": "tiny-k21", "traffic": "ingest", "passes": "ingest",
         "chips": 1, "why": "a cell added by files alone"}))
    spec = tiny("tiny-k21.ingest", genome_len=8000, root=str(tmp_path))
    assert spec["config"]["k"] == 21
    res = run.run_cell(spec, 5, 0.2, False, device="cpu")
    assert res["correct"] and res["metrics"]["reads_per_s"] > 0
    # on the CPU no device memory is taken
    assert res["metrics"]["device_peak_gib"] == 0 == res["peak"]
