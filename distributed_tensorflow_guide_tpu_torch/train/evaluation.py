"""Held-out evaluation: the eval half of the training harness.

The JAX package's ``train/evaluation.py``: an :class:`Evaluator` runs a
data-parallel eval step (``DataParallel.make_eval_step`` or
``make_eval_step_with_stats``, whose metrics are already averaged over the
ranks) over one pass of a finite held-out stream and averages the
per-batch metrics; an :class:`EvalHook` runs it inside the train loop.
Every rank runs the pass (the average is a collective); only the chief
logs.

The sums stay 0-d device tensors during the pass; the host reads them
once, at its end, so an evaluation costs one sync.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable

import torch

from distributed_tensorflow_guide_tpu_torch.core.dist import is_chief
from distributed_tensorflow_guide_tpu_torch.train.hooks import BaseHook

log = logging.getLogger("dtg.train")


class Evaluator:
    """One full pass of ``eval_step(state, batch) -> {name: scalar}`` over
    ``make_data()``, a finite iterable made afresh for every pass.

    Equal-sized batches make the mean of the batch means exact.
    """

    def __init__(self, eval_step: Callable[[Any, Any], dict],
                 make_data: Callable[[], Iterable]):
        self.eval_step = eval_step
        self.make_data = make_data

    def run(self, state: Any) -> dict[str, float]:
        """Evaluate ``state``; the mean metrics plus ``eval_batches``."""
        sums: dict[str, torch.Tensor] = {}
        n = 0
        for batch in self.make_data():
            for k, v in self.eval_step(state, batch).items():
                sums[k] = sums[k] + v if k in sums else torch.as_tensor(v)
            n += 1
        if n == 0:
            raise ValueError(
                "evaluation stream yielded no batches: make_data() must "
                "return a non-empty finite iterable")
        out = {k: float(v) / n for k, v in sums.items()}
        out["eval_batches"] = float(n)
        return out


class EvalHook(BaseHook):
    """Periodic + end-of-run held-out evaluation inside the train loop.

    Runs the evaluator every ``every_steps`` completed steps (0: only at
    the end) and once at ``end``, skipped if the final step already
    evaluated, or if the loop stopped for preemption (a multi-batch pass
    must not eat the SIGTERM grace window the preemption save needs).
    Every rank runs the pass; the chief logs. ``latest`` holds the most
    recent metrics and ``history`` every ``(step, metrics)``. With a
    ``PreemptionHook`` in the same loop, list it FIRST, so that its
    end-phase drain saves before any end-of-run evaluation.
    """

    def __init__(self, evaluator: Evaluator, every_steps: int = 0, *,
                 name: str = "eval"):
        if every_steps < 0:
            raise ValueError("every_steps must be >= 0 (0 = end-of-run only)")
        self.evaluator = evaluator
        self.every_steps = every_steps
        self.name = name
        self.latest: dict[str, float] | None = None
        self.history: list[tuple[int, dict[str, float]]] = []
        self._loop = None
        self._last_eval_step = -1

    def begin(self, loop) -> None:
        self._loop = loop
        self.latest = None
        self.history = []
        self._last_eval_step = -1

    def _evaluate(self, done: int) -> None:
        mets = self.evaluator.run(self._loop.state)
        self.latest = mets
        self.history.append((done, mets))
        self._last_eval_step = done
        if is_chief():
            body = " ".join(f"{k}={v:.4f}" for k, v in mets.items()
                            if k != "eval_batches")
            log.info("eval[%s] step=%d %s (%d batches)", self.name, done,
                     body, int(mets["eval_batches"]))

    def after_step(self, step: int, metrics) -> None:
        done = step + 1  # completed-step count, as checkpoint labels
        if self.every_steps and done % self.every_steps == 0:
            self._evaluate(done)

    def end(self, step: int) -> None:
        if getattr(self._loop, "stop_reason", None) == "preemption":
            return  # the grace window belongs to the preemption save
        if step != self._last_eval_step:
            self._evaluate(step)
