"""The port's regression gate (analysis/regress.py): the persisted
bench-history store and the measured-vs-modeled drift check, as the JAX
package's test_regress.py holds its own.

A synthetic history whose latest entry is inflated past tolerance is
flagged with the right binding resource and the golden-bless join for
its program (the port's goldens), a clean history passes, and the store
keeps its never-raise / drop-corrupt-lines / env-override contracts.
"""

import json

import pytest

from distributed_tensorflow_guide_tpu_torch.analysis import regress


def _decode_result(frac: float) -> dict:
    """A bench_generate-shaped result line, memory-bound at ``frac`` of
    the HBM roofline (compute fraction pinned low)."""
    return {"metric": "gpt2_decode_throughput", "value": 1000.0 * frac,
            "unit": "tokens/sec", "hbm_roofline_frac": frac,
            "flop_roofline_frac": 0.03}


def _entry(frac: float, sha: str, *, row="gpt2_decode",
           program="serve_decode_step", kind="NVIDIA H100 80GB HBM3") -> dict:
    return regress.make_entry(row, _decode_result(frac),
                              device_kind=kind, git_rev=sha,
                              program=program, ts=0.0)


# ---- the store --------------------------------------------------------------


def test_history_path_env_override(monkeypatch, tmp_path):
    monkeypatch.setenv(regress.HISTORY_ENV, str(tmp_path))
    assert regress.history_path() == tmp_path / "history.jsonl"
    monkeypatch.setenv(regress.HISTORY_ENV, str(tmp_path / "x.jsonl"))
    assert regress.history_path() == tmp_path / "x.jsonl"
    monkeypatch.delenv(regress.HISTORY_ENV)
    assert regress.history_path().parts[-2] == regress.DEFAULT_DIRNAME


def test_append_load_roundtrip(monkeypatch, tmp_path):
    monkeypatch.setenv(regress.HISTORY_ENV, str(tmp_path))
    e = _entry(0.8, "aaa1111")
    assert regress.append_entry(e)
    assert regress.append_entry(_entry(0.79, "bbb2222"))
    got = regress.load_history()
    assert len(got) == 2 and got[0] == e
    assert got[0]["efficiency"] == pytest.approx(0.8)
    assert got[0]["bound"] == "memory"  # hbm frac > flop frac


def test_append_never_raises(tmp_path):
    """Best-effort contract: an unwritable destination returns False
    instead of raising (a bench must never fail over bookkeeping)."""
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where a directory must go")
    assert regress.append_entry(_entry(0.8, "x"),
                               path=blocker / "history.jsonl") is False


def test_load_drops_corrupt_lines(monkeypatch, tmp_path):
    monkeypatch.setenv(regress.HISTORY_ENV, str(tmp_path))
    p = regress.history_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    good = _entry(0.8, "aaa1111")
    p.write_text(json.dumps(good) + "\n"
                 + '{"truncated by a crashed run...\n'
                 + "not json at all\n"
                 + json.dumps(["a", "list"]) + "\n")
    assert regress.load_history() == [good]


def test_missing_file_is_empty_history(monkeypatch, tmp_path):
    monkeypatch.setenv(regress.HISTORY_ENV, str(tmp_path / "nowhere"))
    assert regress.load_history() == []
    assert regress.check_history()["ok"]


# ---- make_entry normalization -----------------------------------------------


def test_make_entry_prefers_recon_efficiency():
    """A result line carrying an obs.recon.reconcile output embeds the
    better evidence — efficiency + bound win over roofline fractions."""
    r = {"metric": "m", "value": 1.0, "unit": "u",
         "efficiency": 0.61, "bound": "pcie", "measured_s": 2.0,
         "model_time_s": 1.22, "hbm_roofline_frac": 0.9}
    e = regress.make_entry("row", r, device_kind="k", git_rev="s")
    assert e["efficiency"] == 0.61 and e["bound"] == "pcie"
    assert e["measured_s"] == 2.0 and e["model_time_s"] == 1.22


def test_make_entry_skip_and_bare_rows():
    skip = regress.make_entry("row", {"skipped": "no card"},
                              device_kind="k", git_rev="s")
    assert skip["skipped"] == "no card" and "efficiency" not in skip
    bare = regress.make_entry("row", {"metric": "m", "value": 1, "unit":
                                      "u"}, device_kind="k", git_rev="s")
    assert "efficiency" not in bare and "bound" not in bare


# ---- the gate ---------------------------------------------------------------


def test_clean_history_passes():
    rep = regress.check_history(
        [_entry(0.80, "a"), _entry(0.78, "b"), _entry(0.81, "c")])
    assert rep["ok"] and rep["n_checked"] == 1 and rep["flags"] == []


def test_inflated_entry_flagged_with_bound_and_bless_join():
    """The end-to-end acceptance pin: the latest entry running at half
    the historical HBM fraction (measured/modeled ratio 2x baseline)
    must flag, name 'memory' as the binding resource, and join the
    golden-fingerprint bless reason for the row's program."""
    rep = regress.check_history(
        [_entry(0.80, "aaa1111"), _entry(0.78, "bbb2222"),
         _entry(0.39, "ccc3333")])
    assert not rep["ok"] and len(rep["flags"]) == 1
    f = rep["flags"][0]
    assert f["row"] == "gpt2_decode" and f["bound"] == "memory"
    assert f["latest_git_sha"] == "ccc3333"
    assert f["drift"] > 0.25
    assert f["program"] == "serve_decode_step"
    # the join against analysis/golden_fingerprints.json: the shipped
    # golden for serve_decode_step carries a bless reason
    assert f.get("last_bless")
    # and the rendering names the resource + the reason
    text = regress.render_report(rep)
    assert "memory" in text and f["last_bless"] in text


def test_groups_are_per_device_kind():
    """One slow entry on a DIFFERENT device_kind is a new baseline, not
    a regression — no cross-device normalization by contract."""
    rep = regress.check_history(
        [_entry(0.80, "a"), _entry(0.78, "b"),
         _entry(0.39, "c", kind="NVIDIA A100-SXM4-80GB")])
    assert rep["ok"]  # the A100 group has only one entry: nothing to gate


def test_skipped_entries_never_gate():
    skip = regress.make_entry("gpt2_decode", {"skipped": "row-timeout"},
                              device_kind="NVIDIA H100 80GB HBM3", git_rev="c")
    rep = regress.check_history([_entry(0.8, "a"), _entry(0.78, "b"),
                                 skip])
    assert rep["ok"]


def test_improvement_is_not_flagged():
    rep = regress.check_history(
        [_entry(0.40, "a"), _entry(0.41, "b"), _entry(0.80, "c")])
    assert rep["ok"]  # faster than baseline: not a regression


def test_tolerance_is_respected():
    entries = [_entry(0.80, "a"), _entry(0.80 / 1.2, "b")]  # +20% ratio
    assert regress.check_history(entries, tol=0.25)["ok"]
    assert not regress.check_history(entries, tol=0.15)["ok"]


# ---- selftest + CLI ---------------------------------------------------------


def test_selftest_passes():
    st = regress.selftest()
    assert st["ok"] and st["clean"]["ok"] and not st["inflated"]["ok"]


def test_cli_selftest_and_history(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv(regress.HISTORY_ENV, str(tmp_path))
    assert regress.main(["--selftest"]) == 0
    for e in (_entry(0.8, "a"), _entry(0.39, "b")):
        regress.append_entry(e)
    assert regress.main(["--json"]) == 1
    rep = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert not rep["ok"] and rep["flags"][0]["bound"] == "memory"


def test_device_kind_never_raises_and_names_the_host_without_a_card():
    import torch

    kind = regress.detect_device_kind()
    if not torch.cuda.is_available():
        assert kind.startswith("host-")
    assert regress.make_entry("r", None)["device_kind"] == kind


def test_module_imports_only_the_standard_library():
    import ast
    import pathlib
    import sys

    tree = ast.parse(pathlib.Path(regress.__file__).read_text())
    top = {n.names[0].name.split(".")[0] for n in tree.body
           if isinstance(n, ast.Import)}
    top |= {n.module.split(".")[0] for n in tree.body
            if isinstance(n, ast.ImportFrom) and n.module}
    assert top <= set(sys.stdlib_module_names) | {"__future__"}, top
