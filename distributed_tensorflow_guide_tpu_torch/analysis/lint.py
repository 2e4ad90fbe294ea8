"""The contract linter: run every registered program once, audit its census.

``python -m distributed_tensorflow_guide_tpu_torch.analysis.lint`` imports
the provider modules (``analysis/programs.py``), builds each registered
:class:`~.contracts.ProgramContract` on the device (``--device``, default
``cuda:0``, which raises without a card; the tests pass ``--device
cpu``), runs it once under the census recorder (``analysis/walker.py``)
and audits the census with the rule families of ``analysis/rules.py``.
Exit status 1 on any violation; the report (text or ``--json``) carries
the expected-vs-observed diff per finding.

``--changed-only`` maps ``git diff --name-only <base>`` (plus the working
tree) onto each contract's ``sources``, so a small edit lints only what
it touches; any edit under ``analysis/`` (which holds the closed forms
the cost pins are held to) re-lints everything, and when git cannot
answer the mode falls back to the full audit rather than passing
vacuously.

The drift gate: every linted program's rendered census and derived cost
vector are fingerprinted (``analysis/fingerprint.py``) and compared with
the blessed ``analysis/golden_fingerprints.json``; an unblessed change
exits 1. The goldens are CPU censuses: on the card the fingerprints are
reported, and the gate runs only with ``--device cpu``. ``--cost`` prints
the per-program cost table; ``--bless --reason "why"`` rewrites the
goldens. ``--regress`` selftests the regression gate
(``analysis/regress.py``) and joins the persisted bench history against
the cost model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import traceback
from typing import Any

import torch

# ---- running + rule execution ----------------------------------------------------


@dataclasses.dataclass
class ProgramReport:
    name: str
    ok: bool
    rules: list
    error: str | None = None
    notes: str = ""
    fingerprint: Any = None  # analysis.fingerprint.Fingerprint | None
    census: Any = None  # the run's walker.Census (not serialised)
    #: on a card: torch.cuda.max_memory_allocated's rise over the run
    device_peak_bytes: int | None = None

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok,
                "rules": [r.to_dict() for r in self.rules],
                "error": self.error, "notes": self.notes,
                "fingerprint": (self.fingerprint.to_json()
                                if self.fingerprint else None),
                "counts": self.census.counts() if self.census else None,
                "device_peak_bytes": self.device_peak_bytes}


@dataclasses.dataclass
class LintReport:
    programs: list
    #: fingerprint-vs-golden drift lines (empty = clean); part of ``ok``
    fingerprint_drift: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (all(p.ok for p in self.programs)
                and not self.fingerprint_drift)

    @property
    def n_findings(self) -> int:
        return sum(len(r.findings) for p in self.programs for r in p.rules)

    @property
    def n_cost_pass(self) -> int:
        return sum(1 for p in self.programs for r in p.rules
                   if r.rule == "cost" and r.ok)

    def to_dict(self) -> dict:
        return {"ok": self.ok, "n_programs": len(self.programs),
                "n_pass": sum(p.ok for p in self.programs),
                "n_findings": self.n_findings,
                "n_cost_pass": self.n_cost_pass,
                "fingerprint_drift": list(self.fingerprint_drift),
                "programs": [p.to_dict() for p in self.programs]}


def _run(fn, args, device):
    """One recorded run; on a card also the allocator's peak rise."""
    from distributed_tensorflow_guide_tpu_torch.analysis import walker

    if device.type != "cuda":
        return walker.record(fn, args, device=device) + (None,)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    result, census = walker.record(fn, args, device=device)
    torch.cuda.synchronize(device)
    return result, census, torch.cuda.max_memory_allocated(device) - base


def lint_contract(contract, device="cpu") -> ProgramReport:
    """Build one contract's program on ``device``, run it once under the
    census, and run every rule family over the census."""
    from distributed_tensorflow_guide_tpu_torch.analysis import rules

    device = torch.device(device)
    try:
        fn, args = contract.build(device)
        _, census, peak = _run(fn, args, device)
        traced = rules.TracedProgram(name=contract.name, census=census)
    except Exception:  # a broken build must FAIL lint, not crash it
        return ProgramReport(contract.name, ok=False, rules=[],
                             error=traceback.format_exc(limit=8),
                             notes=contract.notes)
    reports = [rule(traced, contract) for rule in rules.ALL_RULES]
    fp = None
    if traced.cost_vector is not None:  # set by rule_cost
        from distributed_tensorflow_guide_tpu_torch.analysis import (
            fingerprint,
        )
        fp = fingerprint.fingerprint(contract.name, census,
                                     traced.cost_vector)
    return ProgramReport(contract.name, ok=all(r.ok for r in reports),
                         rules=reports, notes=contract.notes,
                         fingerprint=fp, census=census,
                         device_peak_bytes=peak)


def run_contracts(contracts, device="cpu") -> LintReport:
    return LintReport([lint_contract(c, device) for c in contracts])


# ---- registry + --changed-only selection -----------------------------------------


def _registered(names=None):
    from distributed_tensorflow_guide_tpu_torch.analysis import (  # noqa: F401
        programs,  # import for side effect: providers register
    )
    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        registered_contracts,
    )

    return registered_contracts(names)


def _changed_files(base: str) -> list[str] | None:
    """Repo-relative changed paths (committed-vs-base + working tree), or
    None when git can't answer (then the caller lints everything)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out: set[str] = set()
    for cmd in (["git", "diff", "--name-only", base],
                ["git", "status", "--porcelain"]):
        try:
            r = subprocess.run(cmd, cwd=root, capture_output=True,
                               text=True, timeout=30)
        except Exception:
            return None
        if r.returncode != 0:
            return None
        for line in r.stdout.splitlines():
            path = line[3:] if cmd[1] == "status" else line
            if path.strip():
                out.add(path.strip().split(" -> ")[-1])
    return sorted(out)


def _module_path(mod_name: str) -> str | None:
    import importlib.util

    try:
        spec = importlib.util.find_spec(mod_name)
    except (ImportError, ValueError):
        return None
    return spec.origin if spec else None


def select_changed(contracts, base: str) -> tuple[list, str]:
    """The subset of ``contracts`` whose ``sources`` intersect the changed
    files; an ``analysis/`` change (the auditor and its closed forms) or
    unreadable git selects all."""
    changed = _changed_files(base)
    if changed is None:
        return list(contracts), "git unreadable -> full lint"
    if any("/analysis/" in c or c.startswith("analysis/") for c in changed):
        return list(contracts), "analysis/ changed -> full lint"
    changed_rel = {os.path.normpath(c) for c in changed}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    picked = []
    for c in contracts:
        for mod in c.sources:
            path = _module_path(mod)
            if path and os.path.relpath(path, root) in changed_rel:
                picked.append(c)
                break
    return picked, f"{len(changed)} changed file(s)"


def check_fingerprints(report: LintReport, *, full_registry: bool,
                       golden_path=None) -> None:
    """The drift gate: live fingerprints against the blessed goldens;
    mismatch and missing-golden lines land in ``report.fingerprint_drift``
    (part of ``ok``). Stale goldens only fail full-registry runs (a
    ``--programs`` subset says nothing about the rest)."""
    from distributed_tensorflow_guide_tpu_torch.analysis import fingerprint

    goldens = fingerprint.load_goldens(golden_path)
    drift: list[str] = []
    for p in report.programs:
        if p.fingerprint is None:
            continue  # a run error: already a FAIL via p.ok
        drift.extend(fingerprint.diff_fingerprint(p.fingerprint, goldens))
    if full_registry:
        live = {p.name for p in report.programs}
        drift.extend(fingerprint.stale_goldens(live, goldens))
    report.fingerprint_drift = drift


def bless_fingerprints(report: LintReport, reason: str, golden_path=None):
    """Rewrite the goldens from the live fingerprints. Refuses when any
    rule failed: blessed numbers must come from a clean registry."""
    from distributed_tensorflow_guide_tpu_torch.analysis import fingerprint

    broken = [p.name for p in report.programs
              if not p.ok or p.fingerprint is None]
    if broken:
        raise RuntimeError(
            f"refusing to bless with failing/unrunnable programs: "
            f"{broken} — fix the contracts first")
    return fingerprint.save_goldens(
        [p.fingerprint for p in report.programs], reason, golden_path)


def run_lint(names=None, changed_only: bool = False, base: str = "HEAD",
             fingerprints: bool = True, device="cpu") -> LintReport:
    contracts = _registered(tuple(names) if names else None)
    full = names is None and not changed_only
    if changed_only:
        contracts, _why = select_changed(contracts, base)
    report = run_contracts(contracts, device)
    if fingerprints:
        check_fingerprints(report, full_registry=full)
    return report


# ---- rendering --------------------------------------------------------------------


def _fmt_bytes(x: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(x) < 1024 or unit == "GiB":
            return f"{x:,.1f}{unit}" if unit != "B" else f"{x:,.0f}B"
        x /= 1024
    return f"{x:,.1f}GiB"


def render_cost_table(report: LintReport) -> str:
    """The ``--cost`` table: one row per program from the cost rule's
    observations (present whether or not the contract pins anything)."""
    rows = [("program", "flops", "HBM read", "HBM write", "collective",
             "peak live")]
    for p in report.programs:
        obs = next((r.observed for r in p.rules if r.rule == "cost"), None)
        if not obs or "flops" not in obs:
            rows.append((p.name, "-", "-", "-", "-", "-"))
            continue
        coll = sum(obs.get("collective_bytes", {}).values())
        rows.append((p.name, f"{obs['flops']:,.0f}",
                     _fmt_bytes(obs["hbm_bytes_read"]),
                     _fmt_bytes(obs["hbm_bytes_written"]),
                     _fmt_bytes(coll),
                     _fmt_bytes(obs["peak_live_bytes"])))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = []
    for i, r in enumerate(rows):
        out.append("  ".join(
            c.ljust(w) if j == 0 else c.rjust(w)
            for j, (c, w) in enumerate(zip(r, widths))))
        if i == 0:
            out.append("  ".join("-" * w for w in widths))
    return "\n".join(out)


def render_text(report: LintReport, verbose: bool = False) -> str:
    lines = []
    for p in report.programs:
        status = "PASS" if p.ok else "FAIL"
        lines.append(f"{status:4}  {p.name}")
        if p.error:
            lines.append("      run error:")
            lines.extend("      | " + ln
                         for ln in p.error.strip().splitlines()[-6:])
            continue
        for r in p.rules:
            if verbose or not r.ok:
                obs = ", ".join(f"{k}={v}" for k, v in r.observed.items())
                lines.append(f"      {r.rule:12} {'ok' if r.ok else 'FAIL'}"
                             f"  [{obs}]")
            for f in r.findings:
                lines.append(f"        - {f.message}")
                lines.append(f"          expected: {f.expected!r}   "
                             f"observed: {f.observed!r}")
    if report.fingerprint_drift:
        lines.append("FAIL  golden fingerprints (unblessed drift — run "
                     "lint --bless --reason '...'):")
        lines.extend(f"        - {d}" for d in report.fingerprint_drift)
    lines.append(
        f"{'PASS' if report.ok else 'FAIL'}: "
        f"{sum(p.ok for p in report.programs)}/{len(report.programs)} "
        f"programs clean, {report.n_findings} finding(s), "
        f"{len(report.fingerprint_drift)} fingerprint drift(s)")
    return "\n".join(lines)


# ---- CLI -----------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="lint",
        description="Audit every registered program against its declared "
                    "contract (one recorded run on --device).")
    parser.add_argument("--programs", default=None,
                        help="comma-separated program names (default: all)")
    parser.add_argument("--changed-only", action="store_true",
                        help="lint only contracts whose source modules "
                             "changed vs --base / the working tree")
    parser.add_argument("--base", default="HEAD",
                        help="git ref --changed-only diffs against")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--list", action="store_true",
                        help="list registered programs and exit")
    parser.add_argument("--cost", action="store_true",
                        help="print the derived cost table per program")
    parser.add_argument("--bless", action="store_true",
                        help="rewrite analysis/golden_fingerprints.json "
                             "from the live runs (requires --reason; CPU "
                             "only)")
    parser.add_argument("--reason", default=None,
                        help="why the fingerprints changed (stored in the "
                             "golden file; required with --bless)")
    parser.add_argument("--no-fingerprints", action="store_true",
                        help="skip the golden-fingerprint drift gate")
    parser.add_argument("--regress", action="store_true",
                        help="also gate the persisted bench history "
                             "(bench_history/) against the cost model")
    parser.add_argument("--regress-tol", type=float, default=None,
                        help="drift tolerance for --regress (default 0.25)")
    parser.add_argument("--device", default="cuda:0",
                        help="where the programs run (default cuda:0, "
                             "which needs a card; cpu for the plain "
                             "versions of the kernels)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="show per-rule observations for passing rules")
    args = parser.parse_args(argv)

    if args.bless and not args.reason:
        parser.error("--bless requires --reason 'why the programs changed'")
    if args.bless and (args.programs or args.changed_only):
        parser.error("--bless rewrites ALL goldens: run it on the full "
                     "registry (no --programs / --changed-only)")
    from distributed_tensorflow_guide_tpu_torch.core.device import (
        resolve_device,
    )

    device = resolve_device(args.device)
    if args.bless and device.type != "cpu":
        parser.error("the goldens are CPU censuses: bless with --device cpu")
    names = args.programs.split(",") if args.programs else None
    if args.list:
        for c in _registered(None):
            print(f"{c.name:32} sources={','.join(c.sources)}")
        return 0
    contracts = _registered(tuple(names) if names else None)
    full = names is None and not args.changed_only
    if args.changed_only:
        contracts, why = select_changed(contracts, args.base)
        if not args.json:
            print(f"--changed-only: {why}; linting "
                  f"{len(contracts)}/{len(_registered(None))} program(s)")
        if not contracts:
            print("nothing to lint")
            return 0
    report = run_contracts(contracts, device)
    if args.bless:
        try:
            path = bless_fingerprints(report, args.reason)
        except RuntimeError as e:
            print(f"BLESS REFUSED: {e}", file=sys.stderr)
            print(render_text(report, verbose=args.verbose))
            return 1
        print(f"blessed {len(report.programs)} fingerprint(s) -> {path}")
        return 0
    if not args.no_fingerprints and device.type == "cpu":
        check_fingerprints(report, full_registry=full)
    regress_ok = True
    regress_out: dict | None = None
    if args.regress:
        from distributed_tensorflow_guide_tpu_torch.analysis import regress

        tol = (args.regress_tol if args.regress_tol is not None
               else regress.DEFAULT_TOL)
        st = regress.selftest(tol)
        hist = regress.check_history(tol=tol)
        regress_ok = bool(st["ok"]) and bool(hist["ok"])
        regress_out = {"selftest_ok": st["ok"], **hist}
    if args.json:
        d = report.to_dict()
        if regress_out is not None:
            d["regress"] = regress_out
        print(json.dumps(d))
    else:
        if args.cost:
            print(render_cost_table(report))
            print()
        print(render_text(report, verbose=args.verbose))
        if regress_out is not None:
            from distributed_tensorflow_guide_tpu_torch.analysis import (
                regress,
            )

            print(f"regress selftest: "
                  f"{'PASS' if regress_out['selftest_ok'] else 'FAIL'}")
            print(regress.render_report(regress_out))
    return 0 if report.ok and regress_ok else 1


if __name__ == "__main__":
    sys.exit(main())
