"""The training loop — MonitoredTrainingSession.

``state, metrics = step_fn(state, batch)`` over the batches of ``data``
until a hook requests a stop (``while not sess.should_stop():
sess.run(train_op)`` in the reference). The loop stays off the device's
path: PyTorch queues each step's work and returns, and metric values are
0-d device tensors that block only when a hook reads them. Step calls and
the host time between and inside them are counted in ``dispatch_stats``;
with a flight recorder installed (``obs/events.py``) each data wait and
each step call is a span.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable, Iterator, Sequence

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    to_device,
)
from distributed_tensorflow_guide_tpu_torch.train.hooks import Hook
from distributed_tensorflow_guide_tpu_torch.utils.profiling import (
    DispatchStats,
)

log = logging.getLogger("dtg.train")

StepFn = Callable[[Any, Any], tuple[Any, dict]]


class TrainLoop:
    """Drive ``step_fn`` over ``data`` until a hook requests a stop.

    ``device=None`` is the first CUDA card (raises without one); each
    batch is placed there before the step. ``device="cpu"`` runs on the
    CPU.
    """

    def __init__(
        self,
        step_fn: StepFn,
        state: Any,
        data: Iterable,
        hooks: Sequence[Hook] = (),
        start_step: int = 0,
        recorder: Any = None,
        device=None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.hooks = list(hooks)
        self.step = start_step
        self.device = resolve_device(device)
        self._stop = False
        self.stop_reason: str | None = None
        self._last_return: float | None = None
        # observe-only spans; every emission sits behind one attribute
        # check, and nothing recorded feeds the step
        self.rec = recorder if recorder is not None else obs_events.current()
        self.dispatch_stats = DispatchStats()

    def request_stop(self, reason: str = "hook") -> None:
        """Hook-callable stop signal; the first reason wins."""
        if not self._stop:
            self.stop_reason = reason
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def _dispatch(self, batch):
        """One step call with host-gap / call-time accounting."""
        t0 = time.perf_counter()
        if self._last_return is not None:
            self.dispatch_stats.host_gap_s += t0 - self._last_return
        self.state, metrics = self.step_fn(self.state, batch)
        self._last_return = time.perf_counter()
        self.dispatch_stats.dispatch_s += self._last_return - t0
        self.dispatch_stats.dispatches += 1
        return metrics

    def _after_step(self, metrics) -> None:
        for h in self.hooks:
            h.after_step(self.step, metrics)
        self.step += 1
        self.dispatch_stats.steps += 1

    def _span(self, kind: str, name: str) -> None:
        payload = {"name": name, "track": "loop"}
        if kind == "span.begin":
            payload["step"] = self.step
        self.rec.emit(kind, cat="train", actor="loop", payload=payload)

    def run(self) -> Any:
        """Run to completion; returns the final state. ``end`` hooks fire
        only on clean completion; a hook's ``cleanup()`` runs on both
        paths."""
        self._last_return = None
        rec = self.rec
        try:
            for h in self.hooks:
                h.begin(self)
            it: Iterator = iter(self.data)
            while not self._stop:
                if rec.enabled:
                    self._span("span.begin", "data_wait")
                try:
                    batch = to_device(next(it), self.device)
                except StopIteration:
                    break
                finally:
                    if rec.enabled:
                        self._span("span.end", "data_wait")
                if rec.enabled:
                    self._span("span.begin", "dispatch")
                try:
                    self._after_step(self._dispatch(batch))
                finally:
                    if rec.enabled:
                        self._span("span.end", "dispatch")
            for h in self.hooks:
                h.end(self.step)
        finally:
            for h in self.hooks:
                cleanup = getattr(h, "cleanup", None)
                if cleanup is not None:
                    cleanup()
        return self.state
