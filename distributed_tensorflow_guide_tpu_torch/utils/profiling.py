"""Tracing and profiling, on ``torch.profiler``.

The JAX package's ``utils/profiling.py``, for the port:

* :class:`DispatchStats` / :class:`DispatchRecorder` — how many step calls
  a run issued, and how much host time elapsed between them (batch fetch,
  hook work, Python overhead) and inside them (the host side of the call:
  PyTorch queues the device work and returns).
* :func:`trace` — profile everything inside the block into ``logdir`` as a
  Chrome trace (``*.pt.trace.json``; the JAX package writes XPlane).
* :func:`annotate` — a named host-side span (``record_function``).
* :func:`step_annotation` — marks one training step; the span is named as
  the JAX package names it (``"train"`` by default). The step number goes
  into the span's argument string, which torch's Chrome export does not
  keep: in the file, a step is its span's place among the step spans.
* :func:`save_memory_profile` — the CUDA allocator's snapshot (a pickle,
  as ``torch.cuda.memory._dump_snapshot`` writes it).
* :class:`ProfilerHook` — train-loop hook that traces steps
  ``[start_step, end_step)``, with the JAX hook's window logic and its
  ``profiler.start`` / ``profiler.stop`` flight-recorder events.

The device rule of every entry point: the profiler records the card's
activity (CUDA kernels) unless the caller passes ``device="cpu"``; with no
card and no such request it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events

log = logging.getLogger("dtg.profiling")


# -- dispatch / host-gap accounting ------------------------------------------


@dataclasses.dataclass
class DispatchStats:
    """Counters for a stream of step calls."""

    dispatches: int = 0
    steps: int = 0           # optimizer steps
    host_gap_s: float = 0.0  # host time between consecutive step calls
    dispatch_s: float = 0.0  # host time inside step calls

    def as_dict(self) -> dict:
        out = {
            "dispatches": self.dispatches,
            "opt_steps": self.steps,
            "host_gap_s": round(self.host_gap_s, 4),
            "dispatch_enqueue_s": round(self.dispatch_s, 4),
        }
        if self.dispatches:
            out["host_gap_ms_per_dispatch"] = round(
                1e3 * self.host_gap_s / self.dispatches, 3)
        return out


class DispatchRecorder:
    """Wrap a ``(state, batch) -> (state, metrics)`` step so every call
    updates a :class:`DispatchStats` — the standalone instrument for
    benches and ad-hoc loops (``TrainLoop`` keeps its own inline
    accounting)."""

    def __init__(self, step_fn: Callable[[Any, Any], tuple[Any, Any]],
                 steps_per_call: int = 1,
                 stats: DispatchStats | None = None):
        self.step_fn = step_fn
        self.steps_per_call = steps_per_call
        self.stats = stats if stats is not None else DispatchStats()
        self._last_return: float | None = None

    def __call__(self, state, batch):
        t0 = time.perf_counter()
        if self._last_return is not None:
            self.stats.host_gap_s += t0 - self._last_return
        out = self.step_fn(state, batch)
        self._last_return = time.perf_counter()
        self.stats.dispatch_s += self._last_return - t0
        self.stats.dispatches += 1
        self.stats.steps += self.steps_per_call
        return out


# -- traces ------------------------------------------------------------------


def activities(device=None) -> list:
    """The profiler activities for ``device`` (None: this rank's card,
    raising without one): the host's, and the card's on CUDA."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _profiler(logdir: str | Path, device) -> torch.profiler.profile:
    Path(logdir).mkdir(parents=True, exist_ok=True)
    return torch.profiler.profile(
        activities=activities(device),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)))


@contextlib.contextmanager
def trace(logdir: str | Path, *, device=None) -> Iterator[Any]:
    """Profile everything inside the block; the Chrome trace
    (``<host>_<pid>.<ms>.pt.trace.json``) is written under ``logdir`` when
    the block ends. Yields the ``torch.profiler.profile``; view the file in
    Perfetto or ``chrome://tracing``."""
    with _profiler(logdir, device) as prof:
        yield prof
    log.info("profiler trace written to %s", logdir)


def annotate(name: str, **kwargs):
    """Named host-side span; nests. Use around data loading, checkpointing,
    eval — anything host-bound worth seeing on the trace timeline. Keyword
    arguments go into the span's argument string, as ``step_annotation``'s
    step number does."""
    args = ", ".join(f"{k}={v}" for k, v in kwargs.items()) or None
    return torch.profiler.record_function(name, args)


def step_annotation(step: int, name: str = "train"):
    """Mark one step: a span named ``name``, ``step_num=<step>`` as its
    argument string (kept by the profiler's in-memory events, not by the
    Chrome export)."""
    return torch.profiler.record_function(name, f"step_num={step}")


def save_memory_profile(path: str | Path, *, device=None) -> None:
    """Write the CUDA allocator's snapshot (segments and blocks; the
    allocation stacks too where ``torch.cuda.memory._record_memory_history``
    is on) to ``path``, for ``torch.cuda.memory``'s viewer. PyTorch keeps no
    snapshot of CPU allocations: asked for the CPU, this raises
    ``NotImplementedError``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise NotImplementedError(
            "save_memory_profile: PyTorch keeps no allocator snapshot for "
            "the CPU; it is written for a CUDA device only")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with torch.cuda.device(dev):
        torch.cuda.memory._dump_snapshot(str(path))


class ProfilerHook:
    """Trace steps ``[start_step, end_step)`` of the training loop into
    ``logdir`` (a Chrome trace a window). Chief-only is NOT enforced: every
    rank traces its own card; pass ``chief_only=True`` to restrict.
    ``device`` follows the module's device rule. (A train hook by its
    three methods: ``train/loop.py`` imports this module, so it does not
    subclass ``train.hooks.BaseHook``.)"""

    def __init__(self, logdir: str | Path, start_step: int = 10,
                 end_step: int = 15, chief_only: bool = False,
                 recorder=None, device=None):
        if end_step <= start_step:
            raise ValueError("end_step must be > start_step")
        self.logdir = str(logdir)
        self.start_step = start_step
        self.end_step = end_step
        self.chief_only = chief_only
        self.device = resolve_device(device)
        self._active = False
        self._prof: torch.profiler.profile | None = None
        # profiler.start/profiler.stop instants in the flight recorder
        # bracket the trace window
        self.rec = recorder if recorder is not None else obs_events.current()

    def _obs(self, kind: str, step: int | None) -> None:
        if self.rec.enabled:
            self.rec.emit(kind, cat="train", actor="profiler",
                          payload={"logdir": self.logdir, "step": step})

    def _enabled(self) -> bool:
        if not self.chief_only:
            return True
        from distributed_tensorflow_guide_tpu_torch.core.dist import is_chief

        return is_chief()

    def _start(self) -> None:
        self._prof = _profiler(self.logdir, self.device)
        self._prof.start()
        self._active = True

    def _stop(self) -> None:
        # stop() hands the trace to on_trace_ready, which writes it
        self._prof.stop()
        self._prof = None
        self._active = False

    def begin(self, loop) -> None:
        # covers start_step == loop's first step (incl. 0) and warm resumes
        # that land inside the window, where the arming after_step never runs
        if self._active:
            # an elastic restart reuses hook instances and the crashed
            # attempt never ran end(): close its window out
            self._stop()
            self._obs("profiler.stop", None)
        first = getattr(loop, "step", 0)
        if self._enabled() and self.start_step <= first < self.end_step:
            self._start()
            self._obs("profiler.start", first)

    def after_step(self, step: int, metrics) -> None:
        # after_step(step) runs once step `step` is done; start the trace
        # after step start_step-1 so it covers [start_step, end_step).
        if not self._enabled():
            return
        if (not self._active and self.start_step <= step + 1 < self.end_step):
            self._start()
            self._obs("profiler.start", step + 1)
        elif self._active and step + 1 >= self.end_step:
            self._stop()
            self._obs("profiler.stop", step + 1)
            log.info("profiler trace for steps [%d, %d) written to %s",
                     self.start_step, self.end_step, self.logdir)

    def end(self, step: int) -> None:
        if self._active:  # loop stopped mid-window
            self._stop()
            self._obs("profiler.stop", step)
