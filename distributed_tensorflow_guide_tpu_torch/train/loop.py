"""The training loop — MonitoredTrainingSession.

``state, metrics = step_fn(state, batch)`` over the batches of ``data``
until a hook requests a stop (``while not sess.should_stop():
sess.run(train_op)`` in the reference). The loop stays off the device's
path: PyTorch queues each step's work and returns, and metric values are
0-d device tensors that block only when a hook reads them. Step calls and
the host time between and inside them are counted in ``dispatch_stats``.
Each data wait and each step call is a span (``obs/tracing.span``): a
flight-recorder span where a recorder is installed (``obs/events.py``),
and a profiler range while a profiler runs.

``steps_per_call=k > 1``: ``step_fn`` runs k optimizer steps a call
(``DataParallel.make_train_step(steps_per_call=k, stacked_batch=True,
per_step_metrics=True)``, one CUDA graph on the card) and ``data`` yields
one packed item a call (leading axis = inner step; ``DataParallel.
prefetch(..., steps_per_call=k)`` or ``data/prefetch.pack_stream``). The
loop fans the per-step metrics back out, so hooks observe every optimizer
step in order; a stop a hook requests takes effect at the next call
boundary, so a run may overshoot the requesting step by up to k - 1 (by
none for ``StopAtStepHook(n)`` with k dividing n). A short tail pack goes
to ``tail_step_fn`` (a one-step sibling of ``step_fn``), one call a
straggler, or is dropped with a warning. ``dispatch_stats`` counts calls
and optimizer steps apart.

Deadlines (``utils/watchdog.py``): ``data_deadline_s`` bounds one fetch
from the data iterator, ``step_deadline_s`` one step call and its hook
fan-out. A call returns once its work is queued, so a wedged card shows
at the next blocking read, which the step guard covers. A trip dumps
every thread's stack and arrives as a recoverable
:class:`~..utils.watchdog.WatchdogTimeout` (``watchdog_action=
"interrupt"``) or exits the process (``"kill"``), whose supervisor
restarts it. An interrupt lands between bytecodes: a host blocked inside
``torch.cuda.synchronize()`` or a graph replay takes it when the call
returns (``utils/watchdog.py`` states the limit).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable, Iterator, Sequence

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.obs.tracing import span
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

    ``online_tune``: True / False set the process-wide override of the
    tuning table's online front door (``ops/autotune.set_online_tune``),
    None inherits ``DTG_ONLINE_TUNE``. With it on, a tuned value the step
    resolves (the fused-CE chunk) is swept in situ at the first call; a
    ``steps_per_call`` step runs that call eagerly before it captures its
    graph, so the graph holds the tuned value. On the CPU: the defaults.
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
        steps_per_call: int = 1,
        tail_step_fn: StepFn | None = None,
        step_deadline_s: float | None = None,
        data_deadline_s: float | None = None,
        watchdog_action: Any = "interrupt",
        watchdog_diag_path: Any = None,
        online_tune: bool | None = None,
    ):
        if steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        if online_tune is not None:
            from distributed_tensorflow_guide_tpu_torch.ops import autotune

            autotune.set_online_tune(online_tune)
        self.steps_per_call = steps_per_call
        self.tail_step_fn = tail_step_fn
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.hooks = list(hooks)
        self.step = start_step
        self.device = resolve_device(device)
        self.step_deadline_s = step_deadline_s
        self.data_deadline_s = data_deadline_s
        self.watchdog_action = watchdog_action
        self.watchdog_diag_path = watchdog_diag_path
        self._stop = False
        self.stop_reason: str | None = None
        self._last_return: float | None = None
        # observe-only spans; every emission sits behind one attribute
        # check, and nothing recorded feeds the step
        self.rec = recorder if recorder is not None else obs_events.current()
        self.dispatch_stats = DispatchStats()

    def request_stop(self, reason: str = "hook") -> None:
        """Hook-callable stop signal; the first reason wins.
        ``PreemptionHook`` passes "preemption", so that end-phase hooks
        (``EvalHook``) skip work the SIGTERM grace window cannot pay for;
        every rank must pass the same reason."""
        if not self._stop:
            self.stop_reason = reason
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def _dispatch(self, step_fn, batch):
        """One step call with host-gap / call-time accounting."""
        t0 = time.perf_counter()
        if self._last_return is not None:
            self.dispatch_stats.host_gap_s += t0 - self._last_return
        self.state, metrics = step_fn(self.state, batch)
        self._last_return = time.perf_counter()
        self.dispatch_stats.dispatch_s += self._last_return - t0
        self.dispatch_stats.dispatches += 1
        return metrics

    def _after_step(self, metrics) -> None:
        for h in self.hooks:
            h.after_step(self.step, metrics)
        self.step += 1
        self.dispatch_stats.steps += 1

    @staticmethod
    def _pack_len(batch) -> int:
        """The leading length of a packed super-batch (its inner steps)."""
        return int(next(iter(batch.values())).shape[0])

    def _run_packed(self, batch) -> None:
        """One call on a packed item; its per-step metrics go to the hooks
        one step at a time."""
        k = self._pack_len(batch)
        if k < self.steps_per_call:
            # a short tail pack: one single-step call a straggler
            if self.tail_step_fn is None:
                log.warning(
                    "dropping a tail pack of %d < steps_per_call=%d "
                    "batches (no tail_step_fn); pass drop_remainder=True "
                    "upstream to silence, or a tail_step_fn to run them",
                    k, self.steps_per_call)
                return
            for j in range(k):
                if self._stop:
                    return
                single = {n: v[j] for n, v in batch.items()}
                self._after_step(self._dispatch(self.tail_step_fn, single))
            return
        metrics = self._dispatch(self.step_fn, batch)
        if not metrics:  # a step without metrics: nothing to slice
            for _ in range(k):
                self._after_step(metrics)
            return
        lead = {m.shape[0] if m.ndim else None for m in metrics.values()}
        if lead != {k}:
            raise ValueError(
                f"steps_per_call={self.steps_per_call} needs per-step "
                f"metrics (leading axis {k}); got leading sizes {lead} — "
                "build the step with per_step_metrics=True")
        for j in range(k):
            self._after_step({n: m[j] for n, m in metrics.items()})

    def run(self) -> Any:
        """Run to completion; returns the final state. ``end`` hooks fire
        only on clean completion (a crashed step may have left the state
        half-updated, and an end-of-run checkpoint of it would overwrite
        the last good one); a hook's ``cleanup()`` runs on both paths."""
        self._last_return = None
        wd = None
        if self.step_deadline_s or self.data_deadline_s:
            from distributed_tensorflow_guide_tpu_torch.utils.watchdog import (
                Watchdog,
            )

            wd = Watchdog(name="train-loop", action=self.watchdog_action,
                          diag_path=self.watchdog_diag_path,
                          recorder=self.rec)
        rec = self.rec
        try:
            try:
                # begin() inside the try: if a later hook's begin raises,
                # cleanup() still runs for the hooks already begun
                for h in self.hooks:
                    h.begin(self)
                it: Iterator = iter(self.data)
                while not self._stop:
                    if wd and self.data_deadline_s:
                        wd.arm("data iterator", self.data_deadline_s)
                    try:
                        with span(rec, "data_wait", track="loop", actor="loop",
                                  args={"step": self.step}):
                            batch = to_device(next(it), self.device)
                    except StopIteration:
                        break
                    finally:
                        if wd:
                            wd.disarm()
                            wd.check()
                    if wd and self.step_deadline_s:
                        wd.arm("train step", self.step_deadline_s)
                    with span(rec, "dispatch", track="loop", actor="loop",
                              args={"step": self.step}):
                        if self.steps_per_call > 1:
                            self._run_packed(batch)
                        else:
                            self._after_step(self._dispatch(self.step_fn,
                                                            batch))
                    if wd:
                        wd.disarm()
                        wd.check()
                for h in self.hooks:
                    h.end(self.step)
            finally:
                if wd is not None:
                    wd.close()
                for h in self.hooks:
                    cleanup = getattr(h, "cleanup", None)
                    if cleanup is not None:
                        cleanup()
            return self.state
        except KeyboardInterrupt:
            # an "interrupt" trip arrives as KeyboardInterrupt wherever
            # the main thread is, possibly inside the cleanup above:
            # check() re-raises it as the clean WatchdogTimeout; a real
            # Ctrl-C (no trip recorded) re-raises untouched
            if wd is not None:
                wd.check()
            raise
