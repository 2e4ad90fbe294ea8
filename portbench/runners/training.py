"""What the two training runners share: the set-up steps, the timed
window, the traced slice and the comparison with the reference.

A family runner (``train_images``, ``train_lm``) builds one object, the
port's train step with its model and optimizer state, and the feed; this
module drives it from the seed through its first steps (set-up), hands
that same object to the window, and afterwards follows the first
``ref_steps`` steps (the mix's) with the float32 reference on the
batches the feed drew. Where a call is a captured graph of k steps, the
first call runs eagerly and the second is the first replay: the
reference then follows two calls, so the window's replayed graph is
compared as well as its eager warm-up.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from typing import Any, Callable

from portbench import harness
from portbench.reference import compare, precision

@dataclasses.dataclass
class Built:
    """A family runner's program, ready for its first call."""

    model: Any
    state: Any            # the port's TrainState
    step: Any             # the port's train step
    feed: Any             # device batches (the port's prefetch iterator)
    prefetch_stats: Any   # the feed's PrefetchStats
    taps: list            # the first host batches the feed drew
    steps_per_call: int
    ref_steps: int        # steps the reference follows; whole calls
    warm_steps: int       # set-up steps; >= ref_steps
    trace_steps: int
    flops_per_step: int
    attn_shapes: dict | None  # K1-K3 shapes, where the step runs them
    weight_specs: dict
    ref_loss: Callable    # (weights, host batch, fp8=..., half=...) -> loss
    close: Callable = lambda: None


class _Probe:
    """An optimizer pre-step hook: the first gradient's norms, as the
    optimizer gets them. Removed at once, before any graph is captured."""

    def __init__(self, model, optimizer):
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.grad_norms: dict = {}
        self.handle = optimizer.register_step_pre_hook(self)

    def __call__(self, optimizer, args, kwargs):
        import torch

        self.handle.remove()
        self.grad_norms = {
            self.names[id(p)]: float(torch.linalg.vector_norm(
                p.grad.float()))
            for g in optimizer.param_groups for p in g["params"]}


class _Losses:
    """Loop hook: the first ``n`` losses, and the last one; and the
    parameters once the ``n``-th step has returned (the state step n + 1
    starts from)."""

    def __init__(self, model, n: int):
        self.model = model
        self.n = n
        self.first: list = []
        self.last = None
        self.params: dict = {}

    def begin(self, loop):
        pass

    def after_step(self, step, metrics):
        if len(self.first) < self.n:
            self.first.append(metrics["loss"])
            if len(self.first) == self.n:
                self.params = {n: p.detach().to("cpu", copy=True)
                               for n, p in self.model.named_parameters()}
        self.last = metrics["loss"]

    def end(self, step):
        pass


class _StopAt:
    """Loop hook: stop once the host clock passes ``t_end``."""

    def __init__(self, t_end: float):
        self.t_end = t_end
        self.loop = None

    def begin(self, loop):
        self.loop = loop

    def after_step(self, step, metrics):
        if time.perf_counter() >= self.t_end:
            self.loop.request_stop()

    def end(self, step):
        pass


def _loop(b: Built, dev, hooks):
    from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop

    return TrainLoop(b.step, b.state, b.feed, hooks=hooks, device=dev,
                     steps_per_call=b.steps_per_call)


def _stop_after(n: int):
    from distributed_tensorflow_guide_tpu_torch.train.hooks import (
        StopAtStepHook,
    )

    return StopAtStepHook(n)


def _prefetch(b: Built) -> tuple:
    s = b.prefetch_stats
    return s.batches, s.host_wait_s


def run(spec: dict, build: Callable, *, seed: int, seconds: float,
        trace: bool, dev, t_start: float) -> dict:
    import torch

    t_build = time.perf_counter()
    b = build(spec, seed, dev)
    t_built = time.perf_counter()
    probe = _Probe(b.model, b.state.optimizer)
    losses = _Losses(b.model, b.ref_steps)
    loop = tl = None
    try:
        # set-up: the first steps, through the window's own call and feed
        _loop(b, dev, [_stop_after(b.warm_steps), losses]).run()
        harness.sync(dev)
        first_losses = [float(x) for x in losses.first]

        t0 = time.perf_counter()
        setup_s = t0 - t_start
        print("setup: " + json.dumps({
            "to_runner_s": t_build - t_start, "build_s": t_built - t_build,
            "first_steps_s": t0 - t_built}), file=sys.stderr)
        pf0 = _prefetch(b)
        loop = _loop(b, dev, [_StopAt(t0 + seconds), losses])
        loop.run()
        harness.sync(dev)
        window_s = time.perf_counter() - t0
        steps = loop.dispatch_stats.steps
        pf1 = _prefetch(b)
        last_loss = float(losses.last)

        run_data = {
            "window_s": window_s, "steps": steps,
            "train_step_ms": 1e3 * window_s / steps,
            "flops_per_step": b.flops_per_step,
            "input_wait_s": pf1[1] - pf0[1], "input_batches": pf1[0] - pf0[0],
            "host_gap_s": loop.dispatch_stats.host_gap_s,
            "dispatches": loop.dispatch_stats.dispatches,
            "attn_shapes": b.attn_shapes,
        }
        breakdown = None
        if trace:
            with harness.TraceSlice(dev) as sl:
                tl = _loop(b, dev, [_stop_after(b.trace_steps)])
                tl.run()
            run_data["trace"] = sl.reduce()
            run_data["trace_steps"] = tl.dispatch_stats.steps
            tr = run_data["trace"]
            if tr:
                breakdown = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
        device = harness.device_info(dev, 1)
        if trace and run_data.get("trace"):
            device["busy_s"] = run_data["trace"]["busy_s"]
            device["window_s"] = run_data["trace"]["window_s"]
        # a step that never reached the optimizer got no gradient and
        # moved nothing
        prog = {"losses": first_losses,
                "grad_norms": probe.grad_norms or dict.fromkeys(
                    probe.names.values(), 0.0),
                "params": losses.params or None}
        taps = b.taps[:b.ref_steps]
        weight_specs, ref_loss = b.weight_specs, b.ref_loss
    finally:
        b.close()
    # the program's state goes before the reference runs: a process's
    # peak never falls, and the peak was read above
    b = probe = losses = loop = tl = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return finish(spec, seed, dev, prog, taps, run_data, setup_s, device,
                  breakdown, last_loss, weight_specs, ref_loss)


def reference_numbers(spec, seed, dev, taps, weight_specs, ref_loss,
                      fp8=False, half=False, frozen=None) -> dict:
    """The reference's losses, first gradient norms and changes after
    the mix's ``ref_steps``, from the weights drawn again from the seed.
    ``frozen`` (leaf name -> bool) names leaves the optimizer never
    moves: a planted fault."""
    with precision.float32_exact():
        w = harness.seeded_weights(weight_specs, seed, dev)

        def loss_fn(leaves, batch):
            return ref_loss(leaves, batch, fp8=fp8, half=half)

        return compare.reference_steps(loss_fn, w, taps,
                                       spec["mix"]["optimizer"],
                                       int(spec["mix"]["ref_steps"]),
                                       frozen=frozen)


def program_changes(prog: dict, weight_specs, seed, dev) -> dict:
    import torch

    if prog["params"] is None:
        return dict.fromkeys(weight_specs, 0.0)
    w0 = harness.seeded_weights(weight_specs, seed, dev)
    return {n: float(torch.linalg.vector_norm(p.to(dev) - w0[n]))
            for n, p in prog["params"].items()}


def finish(spec, seed, dev, prog, taps, run_data, setup_s, device,
           breakdown, last_loss, weight_specs, ref_loss) -> dict:
    ref = reference_numbers(spec, seed, dev, taps, weight_specs, ref_loss)
    prog_numbers = {"losses": prog["losses"],
                    "grad_norms": prog["grad_norms"],
                    "change_norms": program_changes(prog, weight_specs, seed,
                                                    dev)}
    gaps = compare.train_gaps(prog_numbers, ref,
                              spec["mix"].get("loss_steps"))
    for k in ("losses", "worst_grad", "worst_change", "leaves_compared",
              "leaves"):
        print(f"compare {k}: {json.dumps(gaps[k])}", file=sys.stderr)
    limits = spec["limits"]
    checks = [{"name": k, "value": gaps[k], "limit": v}
              for k, v in limits.items()]
    for k in ("loss_gap", "loss_gap_all", "grad_gap", "change_gap",
              "grad_gap_median", "change_gap_median"):
        if k not in limits:
            print(f"not compared {k}: {gaps[k]!r}", file=sys.stderr)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks)
    steps = run_data["steps"]
    finite = math.isfinite(last_loss)
    return {"correct": correct, "attempted": steps,
            "failed": 0 if finite else steps,
            "end_to_end": {
                "setup_s": {"value": setup_s, "unit": "s"},
                "train_step_ms": {"value": run_data["train_step_ms"],
                                  "unit": "ms"}},
            "run": run_data, "device": device, "breakdown": breakdown,
            "checks": checks, "readings": {
                k: gaps[k] for k in ("loss_gap", "loss_gap_all", "grad_gap",
                                     "change_gap", "grad_gap_median",
                                     "change_gap_median")}}
