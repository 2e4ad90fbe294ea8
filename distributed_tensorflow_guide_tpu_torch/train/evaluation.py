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
    """Held-out evaluation once, at the end of the run; ``latest`` holds
    the metrics. (The JAX package's hook can also evaluate every N steps
    and skips the end pass after a preemption stop; the port has no
    caller of the first yet, and its loop no preemption hook, ROADMAP
    Queue 1 item 11.)"""

    def __init__(self, evaluator: Evaluator):
        self.evaluator = evaluator
        self.latest: dict[str, float] | None = None
        self._loop = None

    def begin(self, loop) -> None:
        self._loop = loop
        self.latest = None

    def end(self, step: int) -> None:
        mets = self.evaluator.run(self._loop.state)
        self.latest = mets
        if is_chief():
            body = " ".join(f"{k}={v:.4f}" for k, v in mets.items()
                            if k != "eval_batches")
            log.info("eval step=%d %s (%d batches)", step, body,
                     int(mets["eval_batches"]))
