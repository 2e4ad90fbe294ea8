"""Continuous regression gate: persisted bench history vs the cost model.

The auditor (``analysis/cost.py``) derives what a program SHOULD cost; a
benchmark measures what it DOES cost; ``obs/recon.py`` joins the two for
one run. This module makes that join *longitudinal*: every measured row
appends one entry to ``bench_history/history.jsonl`` (metric, measured
value, device kind, git sha, and the measured-vs-modeled ratio with its
binding resource) and :func:`check_history` flags a row whose latest
ratio drifted past tolerance against its own per-device baseline. When
the row names a registered program, the report joins the golden
fingerprint's bless ``reason`` that last changed that program: the first
suspect for "the model moved" vs "the machine moved".

Standard library only at import: the history store must be writable from
a benchmark run and readable from CI without torch or a card.
:func:`detect_device_kind` imports torch lazily and asks
``torch.cuda.get_device_name``, degrading to a host label.

Non-guarantees: ``append_entry`` is best-effort (a read-only checkout
must never fail a bench run over bookkeeping), and the gate compares a
row only against ITS OWN history on the SAME device kind: there is no
cross-device normalisation.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import time
from pathlib import Path

#: Env override for the history location: a ``.jsonl`` file path, or a
#: directory (the rolling ``history.jsonl`` lands inside it).
HISTORY_ENV = "DTG_BENCH_HISTORY"

#: Default directory under the repo root; gitignored — history is
#: machine-local evidence, not source.
DEFAULT_DIRNAME = "bench_history"

HISTORY_FILENAME = "history.jsonl"

#: Default drift tolerance: the latest measured/modeled ratio may sit up
#: to 25% above the row's own baseline before the gate flags it. Wide on
#: purpose — bench noise on shared hosts is real; the gate exists to
#: catch step-function regressions (a lost fusion, a new copy), not 3%
#: jitter.
DEFAULT_TOL = 0.25

#: result-line roofline fractions -> the recon/CostVector resource names
#: they reconcile against (the ``bound`` vocabulary).
_FRAC_KEYS = (
    ("flop_roofline_frac", "compute"),
    ("hbm_roofline_frac", "memory"),
    ("ici_roofline_frac", "comm"),
    ("dcn_roofline_frac", "comm"),
    ("pcie_roofline_frac", "pcie"),
)


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def history_path() -> Path:
    """The active history file: :data:`HISTORY_ENV` override (file, or a
    directory to hold ``history.jsonl``), else
    ``<repo>/bench_history/history.jsonl``."""
    raw = os.environ.get(HISTORY_ENV, "").strip()
    if raw:
        p = Path(raw)
        if p.suffix == ".jsonl":
            return p
        return p / HISTORY_FILENAME
    return _repo_root() / DEFAULT_DIRNAME / HISTORY_FILENAME


def detect_device_kind() -> str:
    """``torch.cuda.get_device_name(0)`` when a card is visible, else a
    host-arch label: the grouping key must never raise."""
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:
        pass
    import platform

    return f"host-{platform.machine() or 'unknown'}"


def git_sha() -> str | None:
    """Short HEAD sha, or None outside a readable git checkout."""
    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           cwd=_repo_root(), capture_output=True,
                           text=True, timeout=15)
    except Exception:
        return None
    sha = r.stdout.strip()
    return sha if r.returncode == 0 and sha else None


def make_entry(row: str, result: dict | None, *,
               device_kind: str | None = None,
               git_rev: str | None = None,
               program: str | None = None,
               ts: float | None = None) -> dict:
    """One history entry from a bench's JSON result line.

    ``result`` is a benchmark's JSON result line (or
    None / a ``{"skipped": ...}`` stub). The measured-vs-modeled ratio
    comes from whichever evidence the line carries, best first:
    ``efficiency`` + ``bound`` (an ``obs.recon.reconcile`` output
    embedded in the line), else the roofline fractions
    (``*_roofline_frac`` / ``mfu``) — efficiency is then the binding
    fraction and ``bound`` its resource. Lines with neither are recorded
    (continuity: the row RAN) but carry no ratio and are never flagged.
    """
    entry: dict = {
        "ts": round(time.time() if ts is None else ts, 3),
        "row": row,
        "device_kind": device_kind or detect_device_kind(),
        "git_sha": git_rev if git_rev is not None else git_sha(),
    }
    if program:
        entry["program"] = program
    r = result or {}
    if r.get("skipped"):
        entry["skipped"] = str(r["skipped"])
        return entry
    for k in ("metric", "value", "unit"):
        if k in r:
            entry[k] = r[k]
    if "measured_s" in r:
        entry["measured_s"] = r["measured_s"]
    if "model_time_s" in r:
        entry["model_time_s"] = r["model_time_s"]
    fracs = {}
    for key, resource in _FRAC_KEYS:
        v = r.get(key)
        if isinstance(v, (int, float)) and math.isfinite(v) and v > 0:
            entry[key] = v
            # keep the LARGEST fraction per resource (ici vs dcn)
            fracs[resource] = max(v, fracs.get(resource, 0.0))
    if isinstance(r.get("mfu"), (int, float)) and r["mfu"] > 0:
        entry["mfu"] = r["mfu"]
        fracs.setdefault("compute", r["mfu"])
    if isinstance(r.get("efficiency"), (int, float)) and r["efficiency"] > 0:
        entry["efficiency"] = r["efficiency"]
        if r.get("bound"):
            entry["bound"] = r["bound"]
    elif fracs:
        bound = max(fracs, key=lambda k: fracs[k])
        entry["efficiency"] = round(fracs[bound], 6)
        entry["bound"] = bound
    return entry


def append_entry(entry: dict, path: Path | str | None = None) -> bool:
    """Append one entry to the history file. Best-effort by contract:
    any OS/serialization failure returns False instead of raising — a
    full disk or read-only checkout must not fail the bench that was
    only trying to leave a breadcrumb."""
    p = Path(path) if path else history_path()
    try:
        p.parent.mkdir(parents=True, exist_ok=True)
        line = json.dumps(entry, sort_keys=True)
        with open(p, "a") as f:
            f.write(line + "\n")
        return True
    except Exception:
        return False


def load_history(path: Path | str | None = None) -> list[dict]:
    """Entries from the history file, oldest first; unparseable lines
    are dropped (a truncated tail from a crashed run must not poison
    the readable majority). Missing file -> []."""
    p = Path(path) if path else history_path()
    entries: list[dict] = []
    try:
        text = p.read_text()
    except OSError:
        return entries
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and obj.get("row"):
            entries.append(obj)
    return entries


def _ratio(entry: dict) -> float | None:
    """measured/modeled time ratio (>= ~1.0 on the roofline's terms;
    drift UP = slower than the model says this device can go)."""
    m, t = entry.get("measured_s"), entry.get("model_time_s")
    if (isinstance(m, (int, float)) and isinstance(t, (int, float))
            and m > 0 and t > 0):
        return m / t
    eff = entry.get("efficiency")
    if isinstance(eff, (int, float)) and eff > 0:
        return 1.0 / eff
    return None


def _bless_reason(program: str) -> str | None:
    """The golden-fingerprint bless reason for ``program`` — the last
    recorded "why did this trace change", i.e. the first suspect when a
    row's measured/modeled ratio moved."""
    try:
        from distributed_tensorflow_guide_tpu_torch.analysis import fingerprint

        goldens = fingerprint.load_goldens()
    except Exception:
        return None
    g = goldens.get(program)
    if isinstance(g, dict):
        return g.get("reason")
    return None


def check_history(entries: list[dict] | None = None, *,
                  tol: float = DEFAULT_TOL,
                  path: Path | str | None = None) -> dict:
    """The gate: per (row, device_kind) group, compare the LATEST
    measured/modeled ratio against the median of the prior entries'
    ratios; flag when it drifted more than ``tol`` above baseline.

    Returns ``{"ok", "n_entries", "n_groups", "n_checked", "flags"}``
    where each flag carries the drift arithmetic, the binding resource,
    both git shas, and — when the row names a registered program — the
    golden bless reason that last changed its trace.
    """
    if entries is None:
        entries = load_history(path)
    groups: dict[tuple, list[dict]] = {}
    for e in entries:
        if e.get("skipped"):
            continue
        groups.setdefault((e.get("row"), e.get("device_kind")),
                          []).append(e)
    flags: list[dict] = []
    n_checked = 0
    for (row, kind), group in sorted(groups.items()):
        ratios = [(e, _ratio(e)) for e in group]
        ratios = [(e, r) for e, r in ratios if r is not None]
        if len(ratios) < 2:
            continue  # nothing to drift against yet
        n_checked += 1
        *prior, (latest, latest_r) = ratios
        baseline = statistics.median(r for _, r in prior)
        if baseline <= 0 or latest_r <= baseline * (1.0 + tol):
            continue
        flag = {
            "row": row,
            "device_kind": kind,
            "baseline_ratio": round(baseline, 4),
            "latest_ratio": round(latest_r, 4),
            "drift": round(latest_r / baseline - 1.0, 4),
            "tol": tol,
            "bound": latest.get("bound"),
            "baseline_git_sha": prior[-1][0].get("git_sha"),
            "latest_git_sha": latest.get("git_sha"),
        }
        program = latest.get("program")
        if program:
            flag["program"] = program
            reason = _bless_reason(program)
            if reason:
                flag["last_bless"] = reason
        flags.append(flag)
    return {"ok": not flags, "n_entries": len(entries),
            "n_groups": len(groups), "n_checked": n_checked,
            "flags": flags}


def selftest(tol: float = DEFAULT_TOL) -> dict:
    """Prove the gate end-to-end on synthetic history, no file I/O:
    a clean two-entry row must pass, and the same row with its latest
    measurement inflated past tolerance must flag with the right
    binding resource and program join. Returns ``{"ok": ...}`` plus
    both sub-reports — wired into ``lint --regress`` so the gate itself
    is under test wherever it gates."""
    def entry(ratio: float, sha: str) -> dict:
        return make_entry(
            "synthetic_decode", {
                "metric": "synthetic_decode_throughput",
                "value": 100.0 / ratio, "unit": "tokens/sec",
                # memory-bound decode at 1/ratio of the HBM roofline
                "hbm_roofline_frac": 1.0 / ratio,
                "flop_roofline_frac": 0.05,
            },
            device_kind="synthetic-v0", git_rev=sha,
            program="serve_decode_step", ts=0.0)

    clean = check_history([entry(1.25, "aaaa111"), entry(1.30, "bbb2222")],
                          tol=tol)
    # latest ratio 1.25 * (1 + tol) * 1.6 over baseline: unambiguous
    inflated = check_history(
        [entry(1.25, "aaaa111"), entry(1.25 * (1 + tol) * 1.6, "ccc3333")],
        tol=tol)
    flag = inflated["flags"][0] if inflated["flags"] else {}
    ok = (clean["ok"] and not inflated["ok"]
          and flag.get("bound") == "memory"
          and flag.get("program") == "serve_decode_step"
          and flag.get("latest_git_sha") == "ccc3333")
    return {"ok": ok, "clean": clean, "inflated": inflated}


def render_report(rep: dict) -> str:
    lines = [f"regress: {rep['n_entries']} entr(ies), "
             f"{rep['n_groups']} row group(s), "
             f"{rep['n_checked']} with enough history to gate"]
    for f in rep["flags"]:
        lines.append(
            f"FAIL  {f['row']} on {f['device_kind']}: measured/modeled "
            f"{f['baseline_ratio']} -> {f['latest_ratio']} "
            f"(+{f['drift']:.0%}, tol {f['tol']:.0%}), "
            f"bound by {f['bound'] or 'unknown'} "
            f"[{f['baseline_git_sha']} -> {f['latest_git_sha']}]")
        if f.get("last_bless"):
            lines.append(f"        last trace bless for {f['program']}: "
                         f"{f['last_bless']!r}")
    lines.append("PASS: no unexplained drift" if rep["ok"]
                 else f"FAIL: {len(rep['flags'])} row(s) drifted")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="regress",
        description="Gate persisted bench history against the cost "
                    "model's roofline (measured/modeled ratio drift).")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL)
    ap.add_argument("--path", default=None,
                    help=f"history file (default: ${HISTORY_ENV} or "
                         f"<repo>/{DEFAULT_DIRNAME}/{HISTORY_FILENAME})")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--selftest", action="store_true",
                    help="run the synthetic-history selftest only")
    args = ap.parse_args(argv)

    if args.selftest:
        st = selftest(args.tol)
        print(json.dumps(st) if args.json
              else f"regress selftest: {'PASS' if st['ok'] else 'FAIL'}")
        return 0 if st["ok"] else 1
    rep = check_history(tol=args.tol, path=args.path)
    print(json.dumps(rep) if args.json else render_report(rep))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
