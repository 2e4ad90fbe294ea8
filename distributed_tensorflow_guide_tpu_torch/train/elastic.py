"""Elastic recovery: checkpoint-restart supervision around the train loop.

The JAX package's ``train/elastic.py``. Recovery is restore the newest
valid checkpoint + replay: on a transient failure :func:`run_with_recovery`
restores through the checkpointer's ladder, rebuilds the loop at that step
and continues, up to ``max_restarts``. Anything the loop did after its last
checkpoint is discarded, which is what makes the result equal to an
uninterrupted run (``tests/test_torch_elastic.py``,
``tests/test_torch_chaos.py``).

The port's ``TrainState`` is updated in place, so the state handed in IS
the live state: the supervisor keeps a host copy of it from before the
first step (``checkpoint.host_snapshot``) and a fresh start after a crash
restores that copy in place, as it would a checkpoint.

Cross-process failure detection lives one level down, in
``runtime/multiprocess.py`` (exit codes, timeouts, kill-the-rest).
"""

from __future__ import annotations

import logging
import signal as _signal
from typing import Any, Callable, Iterable, Iterator, Sequence

import torch

from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.train.anomaly import (
    AnomalyDetected,
    AnomalySentinelHook,
)
from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
    Checkpointer,
    CheckpointHook,
    host_snapshot,
    load_snapshot,
)
from distributed_tensorflow_guide_tpu_torch.train.hooks import Hook
from distributed_tensorflow_guide_tpu_torch.train.loop import StepFn, TrainLoop

log = logging.getLogger("dtg.train")


class TooManyRestarts(RuntimeError):
    pass


def _position_of(step: int, skips: set[int]) -> int:
    """Absolute data position of the ``step``-th *trained* batch, given the
    positions already skipped: each skipped position at or before the
    answer shifts it one further down the stream."""
    pos = step
    for s in sorted(skips):
        if s <= pos:
            pos += 1
    return pos


def _skipping_stream(
    make_data: Callable[[int], Iterable], start_step: int, skips: set[int]
) -> Iterator:
    """Yield the batches for steps ``start_step, start_step+1, ...`` from a
    stream with the ``skips`` data positions dropped — the replay path
    after an anomaly rollback asked to skip its offending batch."""
    first_pos = _position_of(start_step, skips)
    it = iter(make_data(first_pos))
    pos = first_pos
    for batch in it:
        if pos not in skips:
            yield batch
        pos += 1


def run_with_recovery(
    step_fn: StepFn,
    init_state: Any,
    make_data: Callable[[int], Iterable],
    checkpointer: Checkpointer,
    *,
    hooks: Sequence[Hook] = (),
    checkpoint_every: int = 100,
    max_restarts: int = 3,
    recoverable: tuple[type[BaseException], ...] = (RuntimeError,),
    async_save: bool = False,
    step_deadline_s: float | None = None,
    data_deadline_s: float | None = None,
    device=None,
) -> Any:
    """Supervised training: run → crash → restore → resume, bounded.

    ``make_data(start_step)`` must yield the batch stream for steps
    ``start_step, start_step+1, ...`` — data position is part of resume
    state, exactly like the reference's global_step-keyed input pipelines.
    Returns the final train state.

    Restores go through the checkpointer's restore ladder
    (:meth:`Checkpointer.restore_latest_valid`): a corrupt or truncated
    newest checkpoint costs one save interval of recomputation instead of
    crash-looping every restart attempt on the same bad files; when NO
    valid checkpoint exists the run degrades to a fresh start.

    Anomaly handling: :class:`~.anomaly.AnomalySentinelHook` instances in
    ``hooks`` are ordered BEFORE the CheckpointHook (a tripped step must
    not be saved), and a trip with ``skip_offending=True`` drops the
    offending batch position from every subsequent replay. ``async_save``
    makes the periodic checkpoints asynchronous (see CheckpointHook);
    ``step_deadline_s``/``data_deadline_s`` arm the loop's watchdog so a
    hang becomes a recoverable :class:`~.utils.watchdog.WatchdogTimeout`
    instead of a silent stall.

    ``device`` goes to each attempt's :class:`~.loop.TrainLoop`. A
    captured step (``core/graphs.MultiStep``) survives a restore: the
    state is restored in place, so the graph's addresses stay valid.
    """
    restarts = 0
    # supervision transitions (restore outcome per attempt, every restart
    # decision) land in the flight recorder
    rec = obs_events.current()
    # the state a fresh start goes back to: the loop updates it in place
    initial = host_snapshot(init_state)
    sentinels = [h for h in hooks if isinstance(h, AnomalySentinelHook)]
    others = [h for h in hooks if not isinstance(h, AnomalySentinelHook)]
    for s in sentinels:
        # force a check on every save boundary: a check_every cadence that
        # misses the step before a save must not let poison be persisted
        s.save_cadence = checkpoint_every
    skips: set[int] = set()
    while True:
        restored = checkpointer.restore_latest_valid(init_state)
        if restored is None:
            # every fresh start, the first included, begins from the
            # snapshot: the state goes back to what the caller handed in
            state = load_snapshot(init_state, initial)
            start = 0
        else:
            state, start = restored
        if rec.enabled:
            rec.emit("elastic.restore", cat="train", actor="supervisor",
                     payload={"start": start, "restarts": restarts,
                              "fresh": restored is None})
        data = (
            _skipping_stream(make_data, start, skips)
            if skips else make_data(start)
        )
        loop = TrainLoop(
            step_fn,
            state,
            data,
            hooks=[*sentinels,
                   CheckpointHook(checkpointer, checkpoint_every,
                                  async_save=async_save),
                   *others],
            start_step=start,
            device=device,
            step_deadline_s=step_deadline_s,
            data_deadline_s=data_deadline_s,
        )
        try:
            return loop.run()
        except recoverable as e:
            restarts += 1
            if rec.enabled:
                rec.emit("elastic.restart", cat="train", actor="supervisor",
                         payload={"step": loop.step, "restarts": restarts,
                                  "error": type(e).__name__})
            if restarts > max_restarts:
                if rec.enabled:
                    rec.crash_dump(
                        "elastic.give_up", cat="train", actor="supervisor",
                        payload={"step": loop.step, "restarts": restarts,
                                 "error": type(e).__name__})
                raise TooManyRestarts(
                    f"gave up after {max_restarts} restarts: {e}"
                ) from e
            if isinstance(e, AnomalyDetected) and e.skip_offending:
                # the whole cannot-exonerate window (every step since the
                # sentinel's last clean check — just the one step at
                # check_every=1) is dropped: skipping only the detection
                # step would leave the actual poison in the replay when
                # the cadence is coarser. Positions are resolved against
                # the CURRENT skip set before any are added.
                window = range(e.window_start, e.step + 1)
                positions = {_position_of(s, skips) for s in window}
                skips |= positions
                log.warning(
                    "anomaly at step %d: skipping data position(s) %s on "
                    "replay", e.step, sorted(positions),
                )
            log.warning(
                "step %d failed (%s); restart %d/%d from checkpoint",
                loop.step, e, restarts, max_restarts,
            )


class PreemptionHook:
    """Graceful preemption: SIGTERM → finish the in-flight step → save →
    stop the loop cleanly.

    Cloud machines receive SIGTERM ahead of maintenance events and spot
    reclaims; the reference's ``run.sh`` supervision simply dies, discarding
    everything since the last periodic checkpoint. This hook defers the
    signal (the handler only sets a flag — no Python state is touched
    mid-step), then after the current step completes saves a checkpoint
    labeled with the completed-step count and requests a clean stop, so a
    restarted job resumes exactly where the preempted one stopped. Combine
    with :func:`run_with_recovery` (or any external restarter) for the full
    preempt→resume cycle.

    Several ranks: SIGTERM delivery is per-process, but the save is a
    collective — every rank must agree before anyone enters it. With a
    ``torch.distributed`` group of more than one rank the flag is therefore
    summed over the ranks (one scalar all-reduce over ``core/dist``'s
    default group) each ``sync_every`` steps, and ALL ranks save and stop
    together as soon as ANY rank was signalled.

    ``preempted_at`` holds the checkpoint label after a preemption, else
    ``None``; it resets on ``begin`` so a reused instance can preempt each
    run it supervises. Original signal handlers are restored when the loop
    exits — crash included (TrainLoop's ``cleanup`` phase).
    """

    def __init__(self, checkpointer: Checkpointer, *, signals=None,
                 sync_every: int = 1):
        self.ckpt = checkpointer
        self.signals = tuple(signals or (_signal.SIGTERM,))
        self.sync_every = sync_every
        self.preempted_at: int | None = None
        self._flagged = False
        self._loop = None
        self._previous: dict = {}

    def begin(self, loop) -> None:
        self._loop = loop
        # a reused instance (external restarter in the same process) starts
        # the new run with fresh signal state: a prior run's preemption
        # must not latch the act-on-it path off for this one
        self.preempted_at = None
        self._flagged = False
        for sig in self.signals:
            prev = _signal.signal(sig, self._on_signal)
            # only the FIRST registration holds the true original handler
            # (our own may still be installed if a crash skipped cleanup
            # in an older runtime; defensive either way)
            if sig not in self._previous:
                self._previous[sig] = prev

    def _on_signal(self, signum, frame) -> None:  # signal context: flag only
        self._flagged = True

    def _agreed_flag(self, step: int | None = None) -> bool:
        """Cluster-wide "anyone signalled?". ``step=None`` is a *final*
        agreement point (loop exit): cadence does not apply, so a SIGTERM
        landing within the last ``sync_every`` steps is still acted on.
        The cadence gates single- and multi-host runs identically — a
        ``sync_every=10`` run reacts at the same step boundaries whether
        it has 1 process or 16, keeping resume points topology-invariant."""
        if step is not None and (step + 1) % self.sync_every:
            return False  # between agreement points nobody acts
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return self._flagged
        dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        flag = torch.tensor([1.0 if self._flagged else 0.0], device=dev)
        dist.all_reduce(flag)
        return bool(flag.item() > 0)

    def _save_and_latch(self, done: int) -> None:
        self.ckpt.save(done, self._loop.state)
        self.ckpt.wait()
        self.preempted_at = done
        rec = obs_events.current()
        if rec.enabled:
            rec.emit("elastic.preempt", cat="train", actor="preemption",
                     payload={"step": int(done)})
        log.warning("preemption signal: saved step %d, stopping", done)

    def after_step(self, step: int, metrics) -> None:
        if self.preempted_at is None and self._agreed_flag(step):
            # checkpoint labels are completed-step counts
            self._save_and_latch(step + 1)
            # "preemption" lets end-phase hooks (EvalHook) skip expensive
            # final work inside the SIGTERM grace window; the decision is
            # collective-agreed, so every host stops with the same reason
            self._loop.request_stop(reason="preemption")

    def end(self, step: int) -> None:
        # Final agreement drain: a flag raised after the last cadence
        # boundary (or during the very last steps) must not be dropped on a
        # normal exit — all hosts reach end() together, so the collective is
        # safe here. Handler restoration lives in cleanup (runs on crashes).
        if self.preempted_at is None and self._agreed_flag():
            self._save_and_latch(step)
            # retag the stop so later end-phase hooks (EvalHook — list it
            # AFTER this hook) skip grace-window-eating work; the drain
            # decision is collective-agreed, so the retag is uniform
            self._loop.stop_reason = "preemption"

    def cleanup(self) -> None:
        """Restore original handlers — TrainLoop guarantees this in a
        ``finally``, so a CRASHED loop cannot leave the flag-only handler
        installed process-wide (where it would silently swallow the
        cluster manager's real SIGTERM forever)."""
        for sig, prev in self._previous.items():
            _signal.signal(sig, prev)
        self._previous.clear()
