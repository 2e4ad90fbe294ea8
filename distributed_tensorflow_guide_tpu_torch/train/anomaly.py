"""Anomaly sentinel — catch NaN/spike steps before a checkpoint persists them.

The silent-poison failure mode: one NaN batch (or an optimizer blow-up)
makes every subsequent step NaN, the periodic CheckpointHook dutifully
saves the poisoned state, and by the time a human looks at the loss curve
the last *good* checkpoint has been garbage-collected. The reference
stack has nothing here; production systems treat loss-scale anomalies as
restartable faults.

:class:`AnomalySentinelHook` checks the host-side metrics after every
``check_every`` steps: loss (and, when present, grad-norm) must be finite
and within ``spike_factor`` of the recent median. On a trip it raises
:class:`AnomalyDetected` — a *recoverable* error that
``train/elastic.py run_with_recovery`` handles by restoring the last good
checkpoint via the restore ladder (the supervisor owns the rollback; the
hook only detects). Because the sentinel runs BEFORE the CheckpointHook in
``run_with_recovery``'s hook order and raising skips the rest of the
after_step fan-out, a tripped step can never be checkpointed.

``skip_offending=True`` additionally asks the supervisor to drop the
offending data *window* from the replayed stream — the escape hatch for
*persistent* data poison (a corrupt shard that NaNs every time), where
plain rollback-and-replay would loop forever. The window is every step
since the last clean check: with ``check_every=1`` that is exactly the
offending batch; with a coarser cadence the unchecked steps in between
cannot be exonerated and are skipped too (detection latency costs
collateral batches — that is the documented price of ``check_every>1``).
Each instance stops after ``budget`` trips by raising
:class:`AnomalyBudgetExceeded`, which is NOT a RuntimeError and therefore
never matches ``run_with_recovery``'s default ``recoverable`` filter: a
run burning its anomaly budget stops loudly.
"""

from __future__ import annotations

import logging
import math
from collections import deque
from typing import Mapping

from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.train.hooks import BaseHook

log = logging.getLogger("dtg.train")


class AnomalyDetected(RuntimeError):
    """A step's metrics tripped the sentinel (recoverable: roll back).

    ``window_start..step`` (inclusive) are the steps that cannot be
    exonerated: everything since the last clean check. With
    ``check_every=1`` the window is the single offending step."""

    def __init__(self, step: int, reason: str, *, skip_offending: bool,
                 window_start: int | None = None):
        super().__init__(f"anomaly at step {step}: {reason}")
        self.step = step
        self.reason = reason
        self.skip_offending = skip_offending
        self.window_start = step if window_start is None else window_start


class AnomalyBudgetExceeded(Exception):
    """Too many anomalies — deliberately NOT a RuntimeError, so the default
    ``run_with_recovery(recoverable=(RuntimeError,))`` lets it escape."""


class AnomalySentinelHook(BaseHook):
    """Host-side finiteness + spike check on per-step metrics.

    ``loss_key``/``grad_norm_key``: metric names to check (a missing
    grad-norm key is simply not checked). ``spike_factor``: a value more
    than this multiple of its own key's recent-window median trips the
    sentinel — loss and grad-norm each keep their own history (requires
    ``window`` prior finite values per key before it activates, so warmup
    noise doesn't false-trip). ``budget``: total trips this instance
    tolerates across restarts — the instance is shared across
    ``run_with_recovery`` attempts, so the budget is per-run, not
    per-restart. ``check_every``: metrics are fetched to host (a device
    sync) only every N steps; anomalies between checks are caught at the
    next one, bounding both detection latency and sync cost — at the price
    of a wider cannot-exonerate window when ``skip_offending`` kicks in.

    A metric may be a 0-d device tensor: it is read (``float``, one sync)
    only at a checked step, and never inside a captured step: the loop
    fans a captured call's per-step metrics out to the hooks after the
    graph ran.
    """

    def __init__(self, *, loss_key: str = "loss",
                 grad_norm_key: str = "grad_norm",
                 spike_factor: float = 10.0, window: int = 20,
                 budget: int = 3, check_every: int = 1,
                 skip_offending: bool = False, recorder=None):
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self.loss_key = loss_key
        self.grad_norm_key = grad_norm_key
        self.spike_factor = spike_factor
        self.window = window
        self.budget = budget
        self.check_every = check_every
        self.skip_offending = skip_offending
        self.trips: list[tuple[int, str]] = []  # (step, reason) log
        self._history: dict[str, deque[float]] = {}
        self._window_start = 0  # first step the NEXT trip can't exonerate
        # Save-boundary forcing, set by run_with_recovery: with
        # check_every > 1 a checkpoint cadence that lands on an unchecked
        # step would persist poison the sentinel hasn't looked at yet —
        # so the step right before every save is ALWAYS checked, keeping
        # the "a tripped state is never checkpointed" guarantee
        # cadence-independent.
        self.save_cadence: int | None = None
        # trips land in the flight recorder; a blown budget crash-dumps
        # the tail (the black-box protocol)
        self.rec = recorder if recorder is not None else obs_events.current()

    def begin(self, loop) -> None:
        # a rolled-back run replays from an older state: the pre-anomaly
        # histories no longer describe the replayed trajectory, and no
        # step before the replay's start can be blamed by the next trip
        self._history.clear()
        self._window_start = loop.step

    def _check_value(self, key: str, value: float) -> str | None:
        if not math.isfinite(value):
            return f"{key}={value} is not finite"
        hist = self._history.get(key, ())
        if len(hist) >= self.window:
            med = sorted(hist)[len(hist) // 2]
            if med > 0 and value > self.spike_factor * med:
                return (f"{key}={value:g} spiked >{self.spike_factor:g}x "
                        f"the recent median {med:g}")
        return None

    def after_step(self, step: int, metrics: Mapping) -> None:
        before_save = (self.save_cadence is not None
                       and (step + 1) % self.save_cadence == 0)
        if step % self.check_every and not before_save:
            return
        reason = None
        clean: list[tuple[str, float]] = []
        for key in (self.loss_key, self.grad_norm_key):
            if key not in metrics:
                continue
            value = float(metrics[key])  # host sync: on-host check
            reason = self._check_value(key, value)
            if reason is not None:
                break
            clean.append((key, value))
        if reason is None:
            for key, value in clean:
                self._history.setdefault(
                    key, deque(maxlen=self.window)).append(value)
            self._window_start = step + 1  # everything up to here is clean
            return
        self.trips.append((step, reason))
        log.warning("anomaly sentinel tripped (%d/%d): %s",
                    len(self.trips), self.budget, reason)
        if self.rec.enabled:
            self.rec.emit("anomaly.trip", cat="train", actor="sentinel",
                          payload={"step": step, "reason": reason,
                                   "trips": len(self.trips),
                                   "budget": self.budget})
        if len(self.trips) > self.budget:
            if self.rec.enabled:
                self.rec.crash_dump(
                    "anomaly.budget_exceeded", cat="train",
                    actor="sentinel",
                    payload={"step": step, "trips": len(self.trips),
                             "budget": self.budget})
            raise AnomalyBudgetExceeded(
                f"{len(self.trips)} anomalies exceed the budget of "
                f"{self.budget}: {self.trips}"
            )
        raise AnomalyDetected(step, reason,
                              skip_offending=self.skip_offending,
                              window_start=self._window_start)
