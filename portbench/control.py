"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --modes program,fp8,half_batch [--seconds 2] [--set key=json]

In one process, for each seed and mode, prints one JSON line with the
numbers the cell compares:

* ``program``: a run of the cell as ``run.py`` makes it, with a short
  window (training needs none: its numbers come from the set-up steps);
  its numbers are the lower readings;
* ``fp8``: the control. Training: the reference put in the program's
  place, its products in fp8 (``reference/precision.py``), on the batches
  the program's feed draws, against the float32 reference. Serving: a
  short run of the program, then at each position of the sampled
  requests' prompts and served tokens, the reference's gap of the token
  the fp8 reference puts first;
* ``half_batch`` (training): the reference in the program's place with
  half of each batch left out, the mean taken over the rest;
* ``conv_frozen`` (training): the reference in the program's place with
  its four-dimensional leaves (the convolution kernels) never moved;
* ``replay_skipped`` (training): the program with every CUDA graph
  replay skipped, so a captured call returns without stepping;
* ``f32`` (training): the program built in float32 and run with TF32
  off: a witness of what bf16 rounding alone makes of each number.

``--set config.key=<json>`` (or ``mix.key=``) changes one value of the
cell's files for this process, as a witness at another setting.

A state left unchanged reads 1 on ``change_gap`` by its definition and
needs no run. The benchmark's own runs never run this script.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402
from portbench.runners import training  # noqa: E402
from portbench.reference import compare, precision  # noqa: E402


def conv_kernel(name, leaf) -> bool:
    return leaf.ndim == 4


def training_fault(spec: dict, seed: int, dev, mode: str) -> dict:
    """The reference in the program's place (``fp8``, ``half_batch`` or
    ``conv_frozen``) against the float32 reference, on the batches the
    program's feed draws for this seed."""
    import torch

    rnr = harness.runner(spec["mix"])
    b = rnr.build(spec, seed, dev)
    n = int(spec["mix"]["ref_steps"])
    try:
        it = iter(b.feed)
        while len(b.taps) < n:
            next(it)
        taps = b.taps[:n]
        specs, ref_loss = b.weight_specs, b.ref_loss
    finally:
        b.close()
    b = it = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    low = training.reference_numbers(
        spec, seed, dev, taps, specs, ref_loss, fp8=mode == "fp8",
        half=mode == "half_batch",
        frozen=conv_kernel if mode == "conv_frozen" else None)
    ref = training.reference_numbers(spec, seed, dev, taps, specs, ref_loss)
    gaps = compare.train_gaps(low, ref, spec["mix"].get("loss_steps"))
    return {k: gaps[k] for k in ("loss_gap", "loss_gap_all", "grad_gap",
                                 "change_gap",
                                 "grad_gap_median", "change_gap_median",
                                 "worst_grad", "worst_change", "losses")}


@contextlib.contextmanager
def program_mode(spec: dict, mode: str):
    """The program as ``mode`` runs it: as it stands, with its graph
    replays skipped, or built in float32 with TF32 off."""
    import torch

    if mode == "program":
        yield spec
    elif mode == "replay_skipped":
        replay = torch.cuda.CUDAGraph.replay
        torch.cuda.CUDAGraph.replay = lambda self: None
        try:
            yield spec
        finally:
            torch.cuda.CUDAGraph.replay = replay
    elif mode == "f32":
        with precision.float32_exact():
            yield dict(spec, config=dict(spec["config"], dtype="float32"))
    else:
        raise ValueError(f"no program mode {mode!r}")


PROGRAM_MODES = ("program", "replay_skipped", "f32")


def reading(spec: dict, seed: int, dev, mode: str, seconds: float) -> dict:
    rnr = harness.runner(spec["mix"])
    serving = spec["mix"]["runner"] == "serve_closed"
    if mode in PROGRAM_MODES or (serving and mode == "fp8"):
        kw = {"control": True} if serving and mode == "fp8" else {}
        with program_mode(spec, "program" if serving else mode) as s:
            out = rnr.run(s, seed=seed, seconds=seconds, trace=False,
                          dev=dev, t_start=time.perf_counter(), **kw)
        got = {c["name"]: c["value"] for c in out["checks"]}
        got.update(out.get("readings", {}))
        if serving and mode == "fp8":
            return {"logit_gap": out["run"]["control_logit_gap"],
                    "served_tokens_compared":
                        got["served_tokens_compared"]}
        return got
    if serving:
        raise ValueError(f"mode {mode!r} is for training cells")
    return training_fault(spec, seed, dev, mode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,fp8")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--set", action="append", default=[],
                    metavar="config.key=json")
    args = ap.parse_args(argv)
    harness.fix_environment()
    spec = harness.cell_spec(args.workload)
    for item in args.set:
        path, value = item.split("=", 1)
        part, key = path.split(".", 1)
        spec[part][key] = json.loads(value)
    dev = harness.require_cards(spec["cell"]["chips"])
    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            got = reading(spec, seed, dev, mode, args.seconds)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "s": time.perf_counter() - t0,
                              **got}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
