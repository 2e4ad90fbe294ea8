"""Training hooks — the MonitoredTrainingSession hook system.

``StopAtStepHook``, ``LoggingHook``, ``StepCounterHook`` and
``MetricsJSONLHook`` as in the JAX package. Hooks never touch the step;
they see host-side step numbers and metric values (0-d tensors, read only
when a hook logs them). Only the chief process writes. ``TensorBoardHook``
and ``MetricsHook`` come with the metrics plane (ROADMAP Queue 1
item 12).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Mapping, Protocol

from distributed_tensorflow_guide_tpu_torch.core.dist import is_chief

log = logging.getLogger("dtg.train")


class Hook(Protocol):
    """Lifecycle: begin() once, after_step() per step, end() once."""

    def begin(self, loop: "Any") -> None: ...  # noqa: E704

    def after_step(self, step: int, metrics: Mapping[str, Any]) -> None: ...  # noqa: E704

    def end(self, step: int) -> None: ...  # noqa: E704


class BaseHook:
    def begin(self, loop) -> None:
        pass

    def after_step(self, step: int, metrics: Mapping[str, Any]) -> None:
        pass

    def end(self, step: int) -> None:
        pass


class StopAtStepHook(BaseHook):
    """Signal the loop to stop at ``last_step``."""

    def __init__(self, last_step: int):
        self.last_step = last_step
        self._loop = None

    def begin(self, loop) -> None:
        self._loop = loop
        if loop.step >= self.last_step:  # resumed already-finished run
            loop.request_stop()

    def after_step(self, step: int, metrics) -> None:
        if step + 1 >= self.last_step:
            self._loop.request_stop()


class LoggingHook(BaseHook):
    """Log scalar metrics every N steps."""

    def __init__(self, every_steps: int = 100):
        self.every_steps = every_steps

    def after_step(self, step: int, metrics) -> None:
        if is_chief() and step % self.every_steps == 0:
            parts = ", ".join(f"{k}={float(v):.6g}"
                              for k, v in metrics.items())
            log.info("step %d: %s", step, parts)


class StepCounterHook(BaseHook):
    """steps/sec and examples/sec/chip every N steps (host clock)."""

    def __init__(self, every_steps: int = 100, batch_size: int | None = None,
                 n_chips: int = 1):
        self.every_steps = every_steps
        self.batch_size = batch_size
        self.n_chips = max(n_chips, 1)
        self._t0: float | None = None
        self._step0 = 0
        self.last_steps_per_sec: float | None = None
        self.last_examples_per_sec_per_chip: float | None = None

    def after_step(self, step: int, metrics) -> None:
        if step % self.every_steps:
            return
        now = time.perf_counter()
        if self._t0 is not None and step > self._step0:
            sps = (step - self._step0) / (now - self._t0)
            self.last_steps_per_sec = sps
            msg = f"{sps:.2f} steps/sec"
            if self.batch_size:
                eps = sps * self.batch_size / self.n_chips
                self.last_examples_per_sec_per_chip = eps
                msg += f", {eps:.1f} examples/sec/chip"
            if is_chief():
                log.info("step %d: %s", step, msg)
        self._t0, self._step0 = now, step


class MetricsJSONLHook(BaseHook):
    """Append one JSON object per logged step to a file."""

    def __init__(self, path: str | Path, every_steps: int = 1):
        self.path = Path(path)
        self.every_steps = every_steps
        self._fh = None

    def begin(self, loop) -> None:
        if is_chief():
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")

    def after_step(self, step: int, metrics) -> None:
        if self._fh and step % self.every_steps == 0:
            rec = {"step": step, "time": time.time()}
            rec.update({k: float(v) for k, v in metrics.items()})
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def end(self, step: int) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
