"""Hang detection — deadlines that turn silent stalls into fail-fast errors.

The reference stack's failure mode for a stall is *nothing*: a worker
blocked on a dead PS's gRPC channel sits there until an operator notices
(SURVEY.md §5). The supervised analogue (`runtime/multiprocess.py`) bounds
a whole RUN with a wall-clock timeout, but inside a run a stalled data
iterator or a wedged dispatch still eats the entire budget before anyone
acts. A watchdog converts those into prompt, diagnosable failures: a
background timer thread that, when a guarded section overruns its
deadline, dumps every thread's stack (the diagnosis), then either
interrupts the main thread (recoverable in-process — the loop re-raises
it as :class:`WatchdogTimeout`, which ``run_with_recovery`` treats like
any crash) or exits the process (``action="kill"`` — the crash-only mode
for hard C-level hangs, which the multiprocess supervisor restarts).

Caveat, stated rather than hidden: ``action="interrupt"`` relies on
``_thread.interrupt_main()``, which fires between Python bytecodes — it
reliably breaks Python-level stalls (a loader stuck in a retry loop, a
socket read in small timeouts) but cannot crack a single blocking C call
that never returns. For those, ``action="kill"`` is the honest tool: the
process dies with a distinctive exit code and the stack dump on disk,
and supervision handles the restart.

On the card the same holds for the CUDA calls that block the host in C:
``torch.cuda.synchronize()``, an event wait, a ``.item()`` or ``.cpu()``
that waits on queued work, a graph replay whose launch queue is full. An
interrupt that fires while one of them waits is delivered when it
returns, so a wedged kernel is not broken by ``"interrupt"``: the trip
still dumps the stacks at the deadline, and the
:class:`WatchdogTimeout` arrives once the call comes back. Use
``action="kill"`` where a kernel may never return.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events

log = logging.getLogger("dtg.watchdog")

KILL_EXIT_CODE = 124  # same convention as coreutils `timeout`


class WatchdogTimeout(RuntimeError):
    """A guarded section overran its deadline (fail-fast, recoverable)."""


class DataStallError(RuntimeError):
    """The upstream data iterator exceeded its per-batch deadline."""


@dataclass
class TripInfo:
    tag: str
    deadline_s: float
    waited_s: float


class Watchdog:
    """Arm/disarm deadline guard backed by one daemon thread.

    ``arm(tag, deadline_s)`` starts the clock; ``disarm()`` stops it; an
    overrun *trips* the watchdog: diagnostics (all-thread stacks via
    ``faulthandler``) go to ``diag_path`` (or stderr), then ``action``
    runs — ``"interrupt"`` (default) raises KeyboardInterrupt in the main
    thread, ``"kill"`` exits the process with :data:`KILL_EXIT_CODE`, or
    a callable receives the :class:`TripInfo`. After a trip the guard is
    disarmed until re-armed; ``check()`` raises :class:`WatchdogTimeout`
    if a trip happened (the cooperative half — the caller that survived
    the interrupt converts it into a clean error).
    """

    def __init__(self, *, name: str = "watchdog",
                 diag_path: str | Path | None = None,
                 action: str | Callable[[TripInfo], None] = "interrupt",
                 poll_s: float = 0.02, recorder=None):
        if isinstance(action, str) and action not in ("interrupt", "kill"):
            raise ValueError(f"unknown watchdog action {action!r}")
        self.name = name
        # a trip is the black-box moment: _dump crash-dumps the
        # flight-recorder tail beside the thread stacks (observe-only;
        # the trip itself is unchanged)
        self.rec = recorder if recorder is not None else obs_events.current()
        self.diag_path = Path(diag_path) if diag_path else None
        self.action = action
        self.poll_s = poll_s
        self.tripped: TripInfo | None = None
        self._lock = threading.Lock()
        self._deadline: float | None = None  # monotonic
        self._armed_at: float | None = None
        self._tag = ""
        self._budget = 0.0
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, name=f"{name}-thread", daemon=True
        )
        self._thread.start()

    def arm(self, tag: str, deadline_s: float) -> None:
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        with self._lock:
            now = time.monotonic()
            self.tripped = None  # a new guard starts clean
            self._tag, self._budget = tag, deadline_s
            self._armed_at, self._deadline = now, now + deadline_s

    def disarm(self) -> None:
        with self._lock:
            self._deadline = self._armed_at = None

    def check(self) -> None:
        """Raise the trip (if any) as a clean :class:`WatchdogTimeout`.

        The trip is NOT cleared here (the next ``arm`` clears it): if the
        trip's ``interrupt_main`` lands while the WatchdogTimeout from a
        cooperative ``check`` is already propagating, the caller's
        KeyboardInterrupt handler can still see the trip and re-raise the
        clean error instead of the raw interrupt."""
        info = self.tripped
        if info is not None:
            raise WatchdogTimeout(
                f"{self.name}: '{info.tag}' exceeded its "
                f"{info.deadline_s:g}s deadline (waited {info.waited_s:.2f}s)"
            )

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5)

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- internals ---------------------------------------------------------

    def _watch(self) -> None:
        while not self._closed.wait(self.poll_s):
            with self._lock:
                deadline = self._deadline
                if deadline is None or time.monotonic() < deadline:
                    continue
                info = TripInfo(self._tag, self._budget,
                                time.monotonic() - self._armed_at)
                # one-shot until re-armed: the interrupt/exit is underway.
                # Publishing `tripped` INSIDE the lock matters: arm() also
                # takes the lock to clear it, so a trip can never be
                # half-committed when the main thread moves on to guard
                # the next section (a late publication would blame a
                # healthy section for the previous one's overrun).
                self._deadline = self._armed_at = None
                self.tripped = info
            self._dump(info)
            self._act(info)

    def _dump(self, info: TripInfo) -> None:
        rec = self.rec
        if rec.enabled:
            try:
                rec.crash_dump(
                    "watchdog.trip", cat="watchdog", actor=self.name,
                    payload={"tag": info.tag,
                             "deadline_s": info.deadline_s,
                             "waited_s": info.waited_s},
                    path=rec.crash_dump_path or (
                        f"{self.diag_path}.flightrec.json"
                        if self.diag_path else None))
            except Exception:
                log.exception("%s: flight-recorder dump failed", self.name)
        try:
            if self.diag_path is not None:
                self.diag_path.parent.mkdir(parents=True, exist_ok=True)
                with self.diag_path.open("a") as fh:
                    fh.write(
                        f"=== {self.name} trip: '{info.tag}' exceeded "
                        f"{info.deadline_s:g}s (waited {info.waited_s:.2f}s) "
                        f"===\n"
                    )
                    faulthandler.dump_traceback(file=fh)
            else:
                faulthandler.dump_traceback(file=sys.stderr)
            log.error(
                "%s: '%s' exceeded %gs deadline (waited %.2fs)%s",
                self.name, info.tag, info.deadline_s, info.waited_s,
                f"; stacks -> {self.diag_path}" if self.diag_path else "",
            )
        except Exception:  # diagnostics must never mask the trip itself
            log.exception("%s: diagnostics dump failed", self.name)

    def _act(self, info: TripInfo) -> None:
        if callable(self.action):
            self.action(info)
        elif self.action == "kill":
            # crash-only: flush what we can, exit with a distinctive code
            # the supervisor (runtime/multiprocess.py) reaps and restarts
            sys.stderr.flush()
            os._exit(KILL_EXIT_CODE)
        else:  # "interrupt"
            import _thread

            _thread.interrupt_main()
