"""Span API + Chrome/Perfetto trace-event JSON exporter.

Spans are just paired events (``span.begin`` / ``span.end``) in the same
flight-recorder stream — no second bookkeeping path. The exporter maps
the serve engine's event vocabulary onto the Chrome trace-event format
(`chrome://tracing` / https://ui.perfetto.dev, "Open trace file"):

* ``span.begin`` / ``span.end``   -> ``B``/``E`` duration events on the
  track named in the payload (train data-wait / dispatch timelines).
* ``prefill.launch`` / ``decode.launch`` -> ``X`` complete events on one
  track per engine slot (``slot0``, ``slot1``, ...), so a request reads
  as queued -> admitted -> prefill chunk(s) -> decode on its slot lane.
* ``req.admit``                   -> an ``X`` on the ``queue`` track
  spanning arrival -> admission (the queue-wait bar).
* everything else                 -> ``i`` instant events (lifecycle
  terminals, prefix hits/evictions, chaos faults, snapshots, ...).

Timestamps: the exporter prefers the semantic clock ``t`` (the engine's
virtual ``now``) and falls back to ``mono`` when ``t`` is None (train
spans). Events whose resolved timestamp is non-finite are skipped —
``ServeEngine.run()`` drains with ``now=inf``, which is meaningful to
the scheduler but not to a timeline. ``pid`` is the event category,
``tid`` the track; both are stable small integers with ``M`` metadata
records carrying the human names.
"""

from __future__ import annotations

import json
import math
from contextlib import contextmanager
from typing import Iterable

from distributed_tensorflow_guide_tpu_torch.obs.events import ObsEvent


@contextmanager
def span(rec, name: str, *, track: str = "main", cat: str = "train",
         actor: str = ""):
    """Emit ``span.begin``/``span.end`` around a block. Payload carries
    the (name, track) pair the exporter turns into a B/E lane."""
    if not rec.enabled:
        yield
        return
    rec.emit("span.begin", cat=cat, actor=actor,
             payload={"name": name, "track": track})
    try:
        yield
    finally:
        rec.emit("span.end", cat=cat, actor=actor,
                 payload={"name": name, "track": track})


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


def to_chrome_trace(events: Iterable) -> dict:
    """Events (ObsEvent objects or dump dicts) -> Chrome trace JSON."""
    ids = _Ids()
    out: list[dict] = []
    for e in events:
        kind, cat, actor, t, mono, payload = _fields(e)
        ts = _ts(t, mono)
        if ts is None:
            continue
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
                     payload=d.get("payload", {}))
            for i, d in enumerate(data.get("events", []))]
