"""Typed structured events + the bounded thread-safe FlightRecorder.

The event model every other obs layer builds on:

* :class:`ObsEvent` — one immutable record: a ``kind`` string
  (dot-namespaced, e.g. ``req.admit`` / ``ckpt.save`` / ``span.begin``),
  a ``cat`` egory (``serve`` / ``train`` / ``ckpt`` / ``chaos`` / ...),
  an ``actor`` (which component emitted it), a ``payload`` dict, and TWO
  timestamps: ``mono`` (``time.monotonic()``, always wall) and ``t`` (the
  *semantic* clock — the serve engine passes its virtual ``now``
  explicitly, a recorder-level injectable ``clock`` covers everything
  else, and ``None`` means "no semantic clock here").
* :class:`FlightRecorder` — a bounded ring buffer (``deque(maxlen=...)``)
  under one lock; ``dump(path)`` writes the tail as JSON and
  ``crash_dump(...)`` is the black-box hook the watchdog/recovery paths
  call on trip: emit the terminal event, then dump.
* :class:`NullRecorder` / :func:`current` — the disabled default. Every
  instrumentation site resolves its recorder ONCE at construction
  (``recorder if recorder is not None else current()``) and guards each
  emission with ``if rec.enabled:`` so a disabled recorder costs one
  attribute check (benchmarks/bench_obs.py pins <1% of a step).
* :func:`signature` — the determinism instrument: a stable tuple view of
  an event sequence that drops the wall clock (``mono``), the semantic
  clock by default, and :data:`VOLATILE` payload keys (wall-measured
  durations), so two seeded runs compare exactly.

Inertness contract: nothing here imports jax and no emission site feeds
a compiled program; the recorder cannot change what the runtime computes,
only what it remembers. Non-guarantees: the ring drops the OLDEST events
under overflow (``dropped`` counts them), ``emit`` ordering across
threads is lock-acquisition order, and payloads are stored by reference
(emitters must pass fresh dicts, which every call site here does).
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

SCHEMA = "dtg-flight-recorder-v1"

#: payload keys that carry wall-measured durations — real data, but noise
#: for the reproducibility signature (two identical seeded runs measure
#: different launch times; everything else they emit is identical).
VOLATILE = frozenset({"dur_s", "waited_s", "queue_wait_s", "ttft_s"})


def _jsonable(v: Any) -> Any:
    """Strict-JSON-safe scalar view: non-finite floats become None."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


@dataclasses.dataclass(frozen=True)
class ObsEvent:
    """One structured event; immutable once emitted."""

    seq: int
    t: float | None  # semantic clock (virtual serve time, injected, ...)
    mono: float      # time.monotonic() at emission — always present
    kind: str
    cat: str
    actor: str
    payload: dict

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "t": _jsonable(self.t),
            "mono": self.mono,
            "kind": self.kind,
            "cat": self.cat,
            "actor": self.actor,
            "payload": {k: _jsonable(v) for k, v in self.payload.items()},
        }


class FlightRecorder:
    """Bounded, ordered, thread-safe ring of :class:`ObsEvent`.

    ``capacity`` bounds memory; overflow drops the oldest event and
    counts it in ``dropped``. ``clock`` (optional zero-arg callable)
    supplies ``t`` when the emitter doesn't pass one — bench_serving's
    virtual clock and the chaos harness pass explicit ``t`` instead.
    ``crash_dump_path`` is where :meth:`crash_dump` writes the tail.
    """

    enabled = True

    def __init__(self, capacity: int = 4096, *,
                 clock: Callable[[], float] | None = None,
                 crash_dump_path: str | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.crash_dump_path = crash_dump_path
        self.dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)

    def emit(self, kind: str, *, cat: str = "misc", actor: str = "",
             payload: dict | None = None,
             t: float | None = None) -> ObsEvent:
        mono = time.monotonic()
        if t is None and self.clock is not None:
            t = self.clock()
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            ev = ObsEvent(self._seq, t, mono, kind, cat, actor,
                          payload if payload is not None else {})
            self._seq += 1
            self._buf.append(ev)
        return ev

    def events(self) -> list[ObsEvent]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def total(self) -> int:
        """Events ever emitted (ring contents + dropped)."""
        return self._seq

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def dump(self, path: str) -> str:
        """Write the ring tail as strict JSON; returns ``path``."""
        with self._lock:
            events = list(self._buf)
            meta = {"schema": SCHEMA, "capacity": self.capacity,
                    "dropped": self.dropped, "total": self._seq}
        with open(path, "w") as f:
            json.dump({**meta, "events": [e.to_dict() for e in events]},
                      f)
        return path

    def crash_dump(self, kind: str, *, cat: str = "crash",
                   actor: str = "", payload: dict | None = None,
                   t: float | None = None,
                   path: str | None = None) -> str | None:
        """The black-box protocol: emit the terminal event, then dump
        the tail to ``path`` / ``crash_dump_path`` (no-op dump when
        neither is set — the event still lands in the ring)."""
        self.emit(kind, cat=cat, actor=actor, payload=payload, t=t)
        path = path if path is not None else self.crash_dump_path
        if path is None:
            return None
        return self.dump(path)


class NullRecorder:
    """The disabled default: every method is a no-op; ``enabled`` is
    False so guarded call sites skip even building the payload dict."""

    enabled = False
    capacity = 0
    dropped = 0
    clock = None
    crash_dump_path = None
    total = 0

    def emit(self, kind: str, *, cat: str = "misc", actor: str = "",
             payload: dict | None = None, t: float | None = None) -> None:
        return None

    def events(self) -> list:
        return []

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        return None

    def dump(self, path: str) -> None:
        return None

    def crash_dump(self, kind: str, *, cat: str = "crash", actor: str = "",
                   payload: dict | None = None, t: float | None = None,
                   path: str | None = None) -> None:
        return None


NULL_RECORDER = NullRecorder()
_current: FlightRecorder | NullRecorder = NULL_RECORDER


def install(rec: FlightRecorder | NullRecorder | None):
    """Install a process-global recorder (``None`` resets to the null
    recorder); returns the previous one so callers can restore it."""
    global _current
    prev = _current
    _current = rec if rec is not None else NULL_RECORDER
    return prev


def current() -> FlightRecorder | NullRecorder:
    """The process-global recorder components resolve at construction."""
    return _current


def signature(events: Iterable, *, include_t: bool = False,
              volatile: frozenset = VOLATILE) -> list[tuple]:
    """Stable comparison view of an event sequence.

    Drops ``seq``/``mono`` always, ``t`` unless ``include_t``, and the
    ``volatile`` payload keys; accepts :class:`ObsEvent` objects or the
    dicts a :meth:`FlightRecorder.dump` round-trips. Two seeded runs of
    the same storm must produce equal signatures (pinned)."""
    out = []
    for e in events:
        if isinstance(e, dict):
            kind, cat, actor = e["kind"], e["cat"], e["actor"]
            t, payload = e.get("t"), e.get("payload", {})
        else:
            kind, cat, actor = e.kind, e.cat, e.actor
            t, payload = e.t, e.payload
        items = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in payload.items() if k not in volatile))
        row: tuple = (kind, cat, actor)
        if include_t:
            row += (t,)
        out.append(row + (items,))
    return out
