"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the mix names the runner under ``runners/`` that builds the
program, warms it up, measures a window of ``--seconds`` and checks what
the window produced against the plain reference. ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics (read by
``metrics/<name>.py``). The last lines of standard error and the
``checks`` key of the result give each number compared beside its limit.

Exits 2 with no result where the card the cell asks for is missing, 3
where JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, as near as Python sees

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.fix_environment()
    try:
        spec = harness.cell_spec(args.workload)
        dev = harness.require_cards(spec["cell"]["chips"])
    except (harness.CellError, OSError, KeyError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    rnr = harness.runner(spec["mix"])
    out = rnr.run(spec, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), dev=dev, t_start=T_START)

    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: the run's process holds {found}: the port must "
              "not load JAX or the JAX package", file=sys.stderr)
        return 3
    names = {m["name"] for m in
             (spec["per_layer"] if args.trace else spec["end_to_end"])}
    if args.trace:
        metrics = harness.read_layer_metrics(spec["per_layer"], out["run"])
    else:
        metrics = {k: v for k, v in out["end_to_end"].items() if k in names}
    line = harness.result_line(
        correct=out["correct"], attempted=out["attempted"],
        failed=out["failed"], metrics=metrics, device=out["device"],
        checks=out["checks"],
        breakdown=out.get("breakdown") if args.trace else None)
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
