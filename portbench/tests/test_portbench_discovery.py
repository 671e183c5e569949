"""Cells, configurations and metrics are found by name, and BENCHMARK.json
keeps to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert {m["name"] for m in b["end_to_end"]} == {"reads_per_s",
                                                    "setup_s"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] == "reads_per_s"
        assert set(m.get("workloads", cells)) <= cells
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in b["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and len(w["why"]) <= 200
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = harness.load_cell(cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert {m["name"] for m in c["end_to_end"]} == {"reads_per_s",
                                                    "setup_s"}
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
    for rel in (c["workload"]["sample"], c["workload"]["trns_ref"],
                c["config"]["whitelist"]):
        assert os.path.isfile(os.path.join(ROOT, rel))


def test_a_cell_and_a_metric_added_as_files_need_no_edit(tmp_path):
    """A later change adds a cell and a metric by adding files and
    BENCHMARK.json entries: the harness finds both by name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    w = json.load(open(root / "portbench" / "workloads" /
                       "gex5p_737k.k562_fusion_4k.json"))
    w["reads_per_sample"] = 1000
    json.dump(w, open(root / "portbench" / "workloads" /
                      "gex5p_737k.k562_small.json", "w"))
    (root / "portbench" / "metrics" / "reads_counted.py").write_text(
        "def read(run):\n    return float(run['reads'])\n")
    b["workloads"].append({"name": "gex5p_737k.k562_small",
                           "config": "gex5p_737k", "traffic": "k562_small",
                           "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "reads_counted", "unit": "reads",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "reads_per_s",
                           "workloads": ["gex5p_737k.k562_small"]})
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    c = harness.load_cell("gex5p_737k.k562_small", str(root))
    assert c["workload"]["reads_per_sample"] == 1000
    assert [m["name"] for m in c["per_layer"]] == ["reads_counted"]
    rd = harness.load_metric("reads_counted", str(root))
    assert rd.read({"reads": 7}) == 7.0
    with pytest.raises(harness.SetupError):
        harness.load_cell("gex5p_737k.no_such_cell", str(root))
