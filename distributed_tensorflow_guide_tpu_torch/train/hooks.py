"""Training hooks — the MonitoredTrainingSession hook system.

``StopAtStepHook``, ``LoggingHook``, ``StepCounterHook``,
``MetricsJSONLHook``, ``TensorBoardHook`` and ``MetricsHook`` as in the
JAX package. Hooks never touch the step; they see host-side step numbers
and metric values (0-d tensors, read only when a hook logs them: on the
card each read waits for the step that made the value). Only the chief
process writes.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Mapping, Protocol

from distributed_tensorflow_guide_tpu_torch.core.dist import is_chief
from distributed_tensorflow_guide_tpu_torch.obs.metrics import (
    Registry,
    absorb_dispatch,
)

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


class TensorBoardHook(BaseHook):
    """Write scalar metrics as TensorBoard event files every
    ``every_steps`` steps through the stdlib-only writer in
    ``utils/tb_writer.py`` (no ``tensorboard`` package needed).
    Chief-only. Metric values are read on the logging steps alone."""

    def __init__(self, logdir, every_steps: int = 1):
        self.logdir = logdir
        self.every_steps = every_steps
        self._writer = None

    def begin(self, loop) -> None:
        if self._writer is not None:  # elastic restart reuses hook instances
            self._writer.close()
            self._writer = None
        if is_chief():
            from distributed_tensorflow_guide_tpu_torch.utils.tb_writer \
                import SummaryWriter

            self._writer = SummaryWriter(self.logdir)

    def after_step(self, step: int, metrics: Mapping[str, Any]) -> None:
        if self._writer and step % self.every_steps == 0:
            self._writer.scalars(
                step, {k: float(v) for k, v in metrics.items()})

    def end(self, step: int) -> None:
        if self._writer:
            self._writer.close()
            self._writer = None


class MetricsHook(BaseHook):
    """Bridge from the loop to the obs metrics plane: every step bumps
    ``dtg_train_steps_total``; every ``every_steps`` steps (and at the
    end) the scalar metrics are mirrored into ``dtg_train_metric_<k>``
    gauges, the loop's dispatch stats are absorbed, and (optionally) the
    registry snapshot goes to a ``utils/tb_writer.SummaryWriter`` via
    ``log_metrics``. Metric values are read on those steps only: the hook
    adds no device wait to the steps between them (the JAX package's
    hook reads every step's values)."""

    def __init__(self, registry: Registry | None = None, *,
                 every_steps: int = 10, writer=None):
        self.registry = registry if registry is not None else Registry()
        self.every_steps = every_steps
        self.writer = writer
        self._loop = None
        self._last = None

    def begin(self, loop) -> None:
        self._loop = loop

    def _mirror(self, metrics) -> None:
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue  # not a scalar
            self.registry.gauge(f"dtg_train_metric_{k}").set(fv)

    def _publish(self, step: int) -> None:
        stats = getattr(self._loop, "dispatch_stats", None)
        if stats is not None:
            absorb_dispatch(self.registry, stats)
        if self.writer is not None and is_chief():
            self.writer.log_metrics(self.registry.snapshot(), step)

    def after_step(self, step: int, metrics) -> None:
        self.registry.counter("dtg_train_steps_total",
                              "optimizer steps observed by MetricsHook").inc()
        self._last = metrics
        if step % self.every_steps:
            return
        self._mirror(metrics)
        self._publish(step)

    def end(self, step: int) -> None:
        if self._last is not None:
            self._mirror(self._last)
            self._last = None
        self._publish(step)
