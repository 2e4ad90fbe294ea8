"""Span API + Chrome/Perfetto trace-event JSON exporter.

One span helper, :class:`span`, serves every timed block of the port. A
block can feed three sinks at once: a caller-owned :class:`PhaseStats`
(host seconds and a count per name, always on where passed), a
``torch.profiler.record_function`` range (only while a profiler runs, so
its cost is paid only then), and ``span.begin`` / ``span.end`` events in
the flight-recorder stream (only where the caller passes an enabled
recorder). With no profiler running and no recorder, a span costs one
flag check, plus two ``perf_counter`` reads where stats are kept.

The exporter maps the serve engine's event vocabulary onto the Chrome
trace-event format (`chrome://tracing` / https://ui.perfetto.dev, "Open
trace file"):

* ``span.begin`` / ``span.end``   -> ``B``/``E`` duration events on the
  track named in the payload (train data-wait / dispatch timelines).
* ``prefill.launch`` / ``decode.launch`` -> ``X`` complete events on one
  track per engine slot (``slot0``, ``slot1``, ...), so a request reads
  as queued -> admitted -> prefill chunk(s) -> decode on its slot lane.
* ``req.admit``                   -> an ``X`` on the ``queue`` track
  spanning arrival -> admission (the queue-wait bar).
* everything else                 -> ``i`` instant events (lifecycle
  terminals, prefix hits/evictions, chaos faults, snapshots, ...).

Timestamps (``clock="semantic"``, the default): the exporter prefers the
semantic clock ``t`` (the engine's virtual ``now``) and falls back to
``mono`` when ``t`` is None (train spans). Events whose resolved
timestamp is non-finite are skipped — ``ServeEngine.run()`` drains with
``now=inf``, which is meaningful to the scheduler but not to a timeline.
``clock="wall"`` places every event at its ``wall_ns`` instead, the Unix
clock ``torch.profiler`` stamps its host and device events with, so the
export and a profiler trace of the same process share one timeline.
``pid`` is the event category, ``tid`` the track; both are stable small
integers with ``M`` metadata records carrying the human names.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Iterable

from distributed_tensorflow_guide_tpu_torch.obs.events import ObsEvent

#: the module whose flag says a torch profiler is running; read through
#: ``sys.modules`` so that this package imports no torch
_PROFILER_MODULE = "torch.autograd.profiler"


def _profiler_running() -> bool:
    """True while a ``torch.profiler`` (or autograd) profile is running
    in this process."""
    prof = sys.modules.get(_PROFILER_MODULE)
    return prof is not None and prof._is_profiler_enabled


class PhaseStats:
    """Host seconds and calls per span name, summed; owned by the caller
    that passes it to :class:`span` (``ServeEngine.tick_phases``)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def snapshot(self) -> dict:
        """``{"seconds": {...}, "counts": {...}}``, copies: the difference
        of two snapshots is what a window spent."""
        return {"seconds": dict(self.seconds), "counts": dict(self.counts)}


class span:
    """A named block, as a context manager.

    ``rec``: a flight recorder (or None); when it is enabled the block is
    a ``span.begin`` / ``span.end`` pair whose payload carries (name,
    track), the begin event ``args`` besides. ``stats``: a
    :class:`PhaseStats` that gets the block's ``perf_counter`` seconds.
    While a profiler runs the block is also a ``record_function`` range
    of the same name, opened after the begin event and closed before the
    end event, so the events' ``wall_ns`` bracket the range."""

    __slots__ = ("rec", "name", "track", "cat", "actor", "args", "stats",
                 "_range", "_t0")

    def __init__(self, rec, name: str, *, track: str = "main",
                 cat: str = "train", actor: str = "",
                 args: dict | None = None, stats: PhaseStats | None = None):
        self.rec, self.name, self.stats = rec, name, stats
        self.track, self.cat, self.actor, self.args = track, cat, actor, args
        self._range = None

    def __enter__(self):
        if self.stats is not None:
            self._t0 = time.perf_counter()
        rec = self.rec
        if rec is not None and rec.enabled:
            payload = {"name": self.name, "track": self.track}
            if self.args:
                payload.update(self.args)
            rec.emit("span.begin", cat=self.cat, actor=self.actor,
                     payload=payload)
        if _profiler_running():
            self._range = sys.modules[_PROFILER_MODULE].record_function(
                self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        rec = self.rec
        if rec is not None and rec.enabled:
            rec.emit("span.end", cat=self.cat, actor=self.actor,
                     payload={"name": self.name, "track": self.track})
        if self.stats is not None:
            self.stats.add(self.name, time.perf_counter() - self._t0)
        return False


def _fields(e) -> tuple[str, str, str, float | None, float, dict]:
    """(kind, cat, actor, t, mono, payload) from an ObsEvent or a dict
    (the shape ``events_from_dump`` round-trips)."""
    if isinstance(e, dict):
        return (e["kind"], e["cat"], e["actor"], e.get("t"),
                e.get("mono", 0.0), e.get("payload", {}))
    return e.kind, e.cat, e.actor, e.t, e.mono, e.payload


def _ts(t: float | None, mono: float) -> float | None:
    """Microsecond timestamp: semantic clock first, wall fallback;
    None = skip this event (non-finite virtual time)."""
    base = t if t is not None else mono
    if base is None or not math.isfinite(base):
        return None
    return base * 1e6


def _wall_us(e) -> float | None:
    """Microsecond Unix timestamp of an event (``wall_ns``); None = an
    event recorded without one."""
    ns = e.get("wall_ns") if isinstance(e, dict) else e.wall_ns
    return None if ns is None else ns / 1e3


class _Ids:
    """Stable first-seen-order pid/tid assignment + metadata records."""

    def __init__(self):
        self.pids: dict[str, int] = {}
        self.tids: dict[tuple[int, str], int] = {}
        self.meta: list[dict] = []

    def pid(self, cat: str) -> int:
        if cat not in self.pids:
            self.pids[cat] = len(self.pids) + 1
            self.meta.append({"ph": "M", "name": "process_name",
                              "pid": self.pids[cat], "tid": 0,
                              "args": {"name": cat}})
        return self.pids[cat]

    def tid(self, pid: int, track: str) -> int:
        key = (pid, track)
        if key not in self.tids:
            self.tids[key] = len(self.tids) + 1
            self.meta.append({"ph": "M", "name": "thread_name",
                              "pid": pid, "tid": self.tids[key],
                              "args": {"name": track}})
        return self.tids[key]


def to_chrome_trace(events: Iterable, clock: str = "semantic") -> dict:
    """Events (ObsEvent objects or dump dicts) -> Chrome trace JSON.

    ``clock``: ``"semantic"`` (``t``, else ``mono``) or ``"wall"``
    (``wall_ns``, skipping events without it). A launch event is emitted
    as its launch ends, so on the wall clock its bar starts ``dur_s``
    before the event; on the semantic clock it starts at the tick's
    ``now``."""
    if clock not in ("semantic", "wall"):
        raise ValueError(f"clock must be 'semantic' or 'wall', got "
                         f"{clock!r}")
    wall = clock == "wall"
    ids = _Ids()
    out: list[dict] = []
    for e in events:
        kind, cat, actor, t, mono, payload = _fields(e)
        ts = _wall_us(e) if wall else _ts(t, mono)
        if ts is None:
            continue
        if wall and kind in ("prefill.launch", "decode.launch"):
            ts -= max(payload.get("dur_s", 0.0), 0.0) * 1e6
        pid = ids.pid(cat)
        if kind in ("span.begin", "span.end"):
            tid = ids.tid(pid, str(payload.get("track", "main")))
            out.append({"ph": "B" if kind == "span.begin" else "E",
                        "name": str(payload.get("name", kind)),
                        "pid": pid, "tid": tid, "ts": ts})
        elif kind == "prefill.launch":
            tid = ids.tid(pid, f"slot{payload.get('slot', 0)}")
            out.append({"ph": "X", "name": f"prefill rid{payload.get('rid')}",
                        "pid": pid, "tid": tid, "ts": ts,
                        "dur": max(payload.get("dur_s", 0.0), 0.0) * 1e6,
                        "args": {k: v for k, v in payload.items()
                                 if k not in ("slot",)}})
        elif kind == "decode.launch":
            dur = max(payload.get("dur_s", 0.0), 0.0) * 1e6
            slots = payload.get("slots", [])
            rids = payload.get("rids", [])
            for slot, rid in zip(slots, rids):
                tid = ids.tid(pid, f"slot{slot}")
                out.append({"ph": "X", "name": f"decode rid{rid}",
                            "pid": pid, "tid": tid, "ts": ts, "dur": dur,
                            "args": {"tick": payload.get("tick")}})
        elif kind == "req.admit":
            wait = payload.get("queue_wait_s")
            tid = ids.tid(pid, "queue")
            if wait is not None and math.isfinite(wait) and wait >= 0:
                out.append({"ph": "X",
                            "name": f"rid{payload.get('rid')} queued",
                            "pid": pid, "tid": tid, "ts": ts - wait * 1e6,
                            "dur": wait * 1e6, "args": dict(payload)})
            else:
                out.append({"ph": "i", "s": "t", "name": kind, "pid": pid,
                            "tid": tid, "ts": ts,
                            "args": dict(payload)})
        else:
            tid = ids.tid(pid, "events")
            out.append({"ph": "i", "s": "t", "name": kind, "pid": pid,
                        "tid": tid, "ts": ts,
                        "args": {"actor": actor, **payload}})
    return {"traceEvents": ids.meta + out,
            "displayTimeUnit": "ms"}


def ttft_breakdown(events: Iterable) -> dict[int, dict[str, float]]:
    """Per-request TTFT split from the serve event stream.

    For every rid that reached a first token:
    ``queue_wait_s`` (arrival -> admission, from ``req.admit``),
    ``prefill_s`` (sum of its prefill launch durations), and
    ``first_decode_s`` (duration of the first decode launch carrying the
    rid; 0.0 when the final prefill chunk itself produced the first
    token). Durations are measured launch wall times — real numbers
    under the bench's virtual clock."""
    queue_wait: dict[int, float] = {}
    prefill: dict[int, float] = {}
    first_decode: dict[int, float] = {}
    first_token: set[int] = set()
    for e in events:
        kind, _cat, _actor, _t, _mono, payload = _fields(e)
        rid = payload.get("rid")
        if kind == "req.admit" and rid is not None:
            w = payload.get("queue_wait_s")
            if w is not None and math.isfinite(w):
                queue_wait.setdefault(rid, w)
        elif kind == "prefill.launch" and rid is not None:
            prefill[rid] = prefill.get(rid, 0.0) + payload.get("dur_s", 0.0)
        elif kind == "decode.launch":
            for r in payload.get("rids", []):
                if r not in first_token:
                    first_decode.setdefault(r, payload.get("dur_s", 0.0))
        elif kind == "req.first_token" and rid is not None:
            first_token.add(rid)
    return {rid: {"queue_wait_s": queue_wait.get(rid, 0.0),
                  "prefill_s": prefill.get(rid, 0.0),
                  "first_decode_s": first_decode.get(rid, 0.0)}
            for rid in sorted(first_token)}


def events_from_dump(path: str) -> list[ObsEvent]:
    """Load a :meth:`FlightRecorder.dump` file back into events."""
    with open(path) as f:
        data = json.load(f)
    return [ObsEvent(seq=d.get("seq", i), t=d.get("t"),
                     mono=d.get("mono", 0.0), kind=d["kind"],
                     cat=d.get("cat", "misc"), actor=d.get("actor", ""),
                     payload=d.get("payload", {}),
                     wall_ns=d.get("wall_ns"))
            for i, d in enumerate(data.get("events", []))]
