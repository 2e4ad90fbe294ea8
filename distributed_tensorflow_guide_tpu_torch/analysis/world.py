"""The auditor's world of ranks: mesh programs linted on every rank.

A mesh program (``ProgramContract.world``) is one program per process:
the JAX package audits it as one SPMD census on 8 fake devices
(``LINT_DEVICES``), the port as N censuses, one a rank. :func:`run_world`
starts ONE world for every mesh program a lint selects, with
``runtime/multiprocess``: N processes joined over gloo, one torch thread
each on the CPU; on the card every rank time-shares ``cuda:0`` and
``collectives.py`` stages what gloo cannot carry through host memory.

Each rank (:func:`rank_main`) turns online tuning off (a tuning sweep is
not part of a program), then runs the programs in order: it builds the
contract's program on its own mesh, records one run under
``walker.record`` (``lint.lint_contract``), runs every rule on its census
under its own contract (``ProgramContract.for_rank``) and prints one
line: its rules, its census's counts, its structure hash. The parent
gathers the lines into one report a program with one ``ProgramReport`` a
rank, holds the ``collective_bytes[...]`` pins to the world mean
(``rules.rule_world_cost``) and fingerprints the program as a hash over
every rank's structure hash in rank order.

A rank whose program raises reports its traceback and leaves at once, so
its peers, blocked on it in a collective, fail fast (gloo) instead of
waiting out their timeout; a rank that hangs is killed at the world's
deadline. Either way the program fails with the failing ranks'
tracebacks (or, for a rank that never reported, its exit and stderr),
the programs after it are reported as not run, and no program passes on
fewer ranks than the world.

Import discipline: torch only; nothing here imports the JAX package.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys

#: the world's deadline, seconds: process start, every program, exit
WORLD_TIMEOUT_S = 900.0
_LINE = "DTG_LINT_RANK "


def contracts_by_name(names, providers=()) -> list:
    """The contracts ``names`` from the registry, or from the
    ``lint_contracts()`` of the modules ``providers`` (which are not
    registered: programs a test plants stay out of the registry)."""
    from distributed_tensorflow_guide_tpu_torch.analysis import lint

    extra = {c.name: c for mod in providers
             for c in importlib.import_module(mod).lint_contracts()}
    rest = [n for n in names if n not in extra]
    found = {c.name: c for c in lint._registered(tuple(rest))} if rest \
        else {}
    return [extra.get(n) or found[n] for n in names]


def _rank_line(contract, device, rank: int) -> dict:
    from distributed_tensorflow_guide_tpu_torch.analysis import (
        fingerprint,
        lint,
        walker,
    )

    rep = lint.lint_contract(contract, device)
    out = {"program": contract.name, "rank": rank, "error": rep.error,
           "rules": [r.to_dict() for r in rep.rules]}
    if rep.census is not None:
        out.update(counts=rep.census.counts(),
                   collectives=dict(walker.collective_census(rep.census)),
                   structure=fingerprint.structure_hash(rep.census),
                   device_peak_bytes=rep.device_peak_bytes)
    return out


def rank_main(names: list, device: str, providers: list) -> dict:
    """One rank of the world (started by ``runtime/multiprocess``): lint
    ``names`` in order, one line a program on stdout."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.ops import autotune

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    autotune.set_online_tune(False)
    rank = dist.get_rank()
    for c in contracts_by_name(names, providers):
        line = _rank_line(c.for_rank(rank), dev, rank)
        print(_LINE + json.dumps(line), flush=True)
        if line["error"] is not None:
            sys.stderr.flush()
            os._exit(1)  # the peers fail fast instead of blocking on us
    return {"programs": len(names)}


# ---- the parent -------------------------------------------------------------


def _rank_report(line: dict):
    from distributed_tensorflow_guide_tpu_torch.analysis import lint, rules

    reports = [rules.RuleReport(
        r["rule"], r["observed"],
        [rules.Finding(**f) for f in r["findings"]]) for r in line["rules"]]
    return lint.ProgramReport(
        f"{line['program']}@rank{line['rank']}",
        ok=line["error"] is None and all(r.ok for r in reports),
        rules=reports, error=line["error"],
        device_peak_bytes=line.get("device_peak_bytes"),
        rank_counts={**line.get("counts", {}),
                     "collectives": line.get("collectives", {})})


def _world_report(contract, lines: list[dict]):
    from distributed_tensorflow_guide_tpu_torch.analysis import (
        cost as cm,
        fingerprint,
        lint,
        rules,
    )

    ranks = [_rank_report(line) for line in lines]
    costs = [next((r.observed for r in rep.rules if r.rule == "cost"), {})
             for rep in ranks]
    if any("flops" not in c for c in costs):
        return lint.ProgramReport(contract.name, ok=False, rules=[],
                                  notes=contract.notes, ranks=ranks)
    vec = cm.world_mean([cm.CostVector(
        flops=c["flops"], hbm_bytes_read=c["hbm_bytes_read"],
        hbm_bytes_written=c["hbm_bytes_written"],
        collective_bytes=c["collective_bytes"],
        peak_live_bytes=c["peak_live_bytes"]) for c in costs])
    world_rule = rules.rule_world_cost(
        vec, [c.get("world_pins", []) for c in costs])
    structure = hashlib.sha256("".join(
        f"{line['rank']}:{line['structure']}\n" for line in lines
    ).encode()).hexdigest()
    fp = fingerprint.Fingerprint(contract.name, structure,
                                 fingerprint._round(vec.to_dict()))
    return lint.ProgramReport(
        contract.name, ok=world_rule.ok and all(r.ok for r in ranks),
        rules=[world_rule], notes=contract.notes, fingerprint=fp,
        ranks=ranks)


def _failed(lines: dict, results, world: int) -> str:
    """Why a program has no clean report from every rank."""
    out = []
    for rank in range(world):
        line = lines.get(rank)
        if line is not None and line["error"] is not None:
            out.append(f"rank {rank}:\n{line['error']}")
        elif line is None:
            res = results[rank]
            how = ("killed at the world's deadline or after a peer failed"
                   if res.returncode is None
                   else f"exit {res.returncode}")
            out.append(f"rank {rank}: no report ({how}); stderr:\n"
                       + res.stderr[-1500:])
    return "\n".join(out)


def run_world(contracts, world: int, device="cpu", *,
              providers=()) -> list:
    """Lint the mesh programs ``contracts`` on every rank of ONE world of
    ``world`` processes on ``device``; one ``ProgramReport`` a program,
    in order (``ranks`` holds the per-rank reports). ``providers``:
    modules whose ``lint_contracts()`` hold contracts the registry does
    not (the ranks look them up there)."""
    from distributed_tensorflow_guide_tpu_torch.analysis import lint
    from distributed_tensorflow_guide_tpu_torch.runtime.multiprocess import (
        MultiProcessRunner,
    )

    names = [c.name for c in contracts]
    runner = MultiProcessRunner(
        "distributed_tensorflow_guide_tpu_torch.analysis.world:rank_main",
        world, [names, str(device), list(providers)],
        timeout=WORLD_TIMEOUT_S)
    results = runner.start().join(raise_on_error=False)
    by_program: dict[str, dict[int, dict]] = {n: {} for n in names}
    for res in results:
        for text in res.stdout.splitlines():
            if text.startswith(_LINE):
                line = json.loads(text[len(_LINE):])
                by_program[line["program"]][line["rank"]] = line
    reports, ended = [], None
    for c in contracts:
        lines = by_program[c.name]
        if ended is not None:
            reports.append(lint.ProgramReport(
                c.name, ok=False, rules=[], notes=c.notes,
                error=f"not run: the world ended at {ended}"))
            continue
        if len(lines) == world and all(
                line["error"] is None for line in lines.values()):
            reports.append(_world_report(
                c, [lines[r] for r in range(world)]))
            continue
        ended = c.name
        reports.append(lint.ProgramReport(
            c.name, ok=False, rules=[], notes=c.notes,
            error=_failed(lines, results, world),
            ranks=[_rank_report(lines[r]) for r in sorted(lines)]))
    return reports
