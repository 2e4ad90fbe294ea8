"""The harness finds a cell's files by name: a later change adds a
configuration, a traffic mix, limits and a metric reader, and edits no
file that is there."""

import json
import shutil
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "portbench"
    cfg = json.loads((bench / "configs" / "gpt2-124m.json").read_text())
    cfg["name"] = "gpt2-new"
    (bench / "configs" / "gpt2-new.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "chat_closed64.json").read_text())
    mix["clients"] = 32
    (bench / "traffic" / "chat_closed32.json").write_text(json.dumps(mix))
    (bench / "limits" / "gpt2_new_chat32.json").write_text(
        json.dumps({"logit_gap": 0.5}))
    (bench / "metrics" / "ticks.serve.py").write_text(
        "def read(run):\n    return run.get('ticks')\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "gpt2-new", "source": cfg["source"],
                            "file": "portbench/configs/gpt2-new.json",
                            "reduced": cfg["reduced"], "why": "a test"})
    spec["workloads"].append({"name": "gpt2_new_chat32",
                              "config": "gpt2-new",
                              "traffic": "chat_closed32", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "ticks.serve", "unit": "ticks",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "host scheduler",
                              "moves": "serve_tokens_per_s",
                              "workloads": ["gpt2_new_chat32"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "gpt2_serve_chat64" in m["workloads"]:
            m["workloads"].append("gpt2_new_chat32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    got = harness.cell_spec("gpt2_new_chat32", root=tmp_path)
    assert got["config"]["name"] == "gpt2-new"
    assert got["mix"]["clients"] == 32
    assert got["limits"] == {"logit_gap": 0.5}
    assert "ticks.serve" in [m["name"] for m in got["per_layer"]]
    rnr = harness.runner(got["mix"], root=tmp_path)
    assert callable(rnr.run)
    metrics = harness.read_layer_metrics(
        [m for m in got["per_layer"] if m["name"] == "ticks.serve"],
        {"ticks": 7}, root=tmp_path)
    assert metrics == {"ticks.serve": {"value": 7.0, "unit": "ticks"}}


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    per_layer = [m for m in harness.benchmark_spec()["per_layer"]
                 if m["source"] == "device_trace"]
    run = {"trace": {}, "tick_n": {}, "tick_s": {}}
    assert harness.read_layer_metrics(per_layer, run) == {}
