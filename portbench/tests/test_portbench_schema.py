"""``BENCHMARK.json`` against the rules a benchmark file keeps to, and the result
line's schema."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    everything = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
                  + SPEC["per_layer"])
    for e in everything:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
    assert len({e["name"] for e in everything}) == len(everything)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]
    pairs = set()
    for w in SPEC["workloads"]:
        n = w["name"]
        pairs.add((w["config"], w["traffic"]))
        mine = [m for m in SPEC["end_to_end"]
                if n in m.get("workloads", [n])]
        assert len(mine) >= 2 and "setup_s" in [m["name"] for m in mine]
        layer = [m for m in SPEC["per_layer"]
                 if n in m.get("workloads", [n])]
        assert layer
        for m in layer:  # a cell that lists a metric reports what it moves
            assert n in e2e[m["moves"]].get("workloads", [n])
    assert len(pairs) == len(SPEC["workloads"])


def test_each_layer_has_one_name_and_each_metric_a_reader():
    for m in SPEC["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    s = harness.cell_spec(cell)
    assert s["mix"]["runner"]
    assert (ROOT / "portbench" / "runners"
            / f"{s['mix']['runner']}.py").is_file()
    assert s["limits"]


def test_result_line_keys_and_checks_last():
    line = harness.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"setup_s": {"value": 1.5, "unit": "s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": 1, "memory_peak_bytes": 1},
        checks=[{"name": "logit_gap", "value": 0.01, "limit": 0.1}],
        breakdown={"device_ops": [["k", 0.1]], "idle_gaps": []})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"] == [{"name": "logit_gap", "value": 0.01,
                               "limit": 0.1}]
    json.dumps(line)


def test_percentile():
    assert harness.percentile([1, 2, 3, 4, 5], 50) == 3
    assert harness.percentile(list(range(101)), 95) == 95
    assert harness.percentile([2.0, 4.0], 50) == 3.0
