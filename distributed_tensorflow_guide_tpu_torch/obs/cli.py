"""``dtg-obs``: inspect a flight-recorder dump, convert to Chrome trace.

    dtg-obs crash.json                    # pretty-print the event tail
    dtg-obs crash.json --kind req.        # only request-lifecycle events
    dtg-obs crash.json --chrome out.json  # -> chrome://tracing / Perfetto
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_tensorflow_guide_tpu_torch.obs.tracing import (
    events_from_dump,
    to_chrome_trace,
)


def _fmt(e) -> str:
    t = "-" if e.t is None else f"{e.t:.6f}"
    payload = json.dumps(e.payload, sort_keys=True, default=str)
    return (f"{e.seq:6d}  t={t:>12}  {e.cat:<9} {e.kind:<20} "
            f"{e.actor:<14} {payload}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dtg-obs",
        description="Pretty-print a flight-recorder dump or convert it "
                    "to Chrome/Perfetto trace-event JSON.")
    ap.add_argument("dump", help="path to a FlightRecorder.dump() file")
    ap.add_argument("--chrome", metavar="OUT", default=None,
                    help="write Chrome trace-event JSON to OUT instead "
                         "of printing events")
    ap.add_argument("--kind", default=None,
                    help="only events whose kind contains this substring")
    ap.add_argument("--limit", type=int, default=0,
                    help="print only the last N events (0 = all)")
    args = ap.parse_args(argv)

    try:
        with open(args.dump) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"dtg-obs: cannot read {args.dump}: {e}", file=sys.stderr)
        return 1
    events = events_from_dump(args.dump)

    if args.chrome:
        trace = to_chrome_trace(events)
        with open(args.chrome, "w") as f:
            json.dump(trace, f)
        print(f"wrote {len(trace['traceEvents'])} trace event(s) from "
              f"{len(events)} recorder event(s) -> {args.chrome}")
        return 0

    if args.kind:
        events = [e for e in events if args.kind in e.kind]
    if args.limit > 0:
        events = events[-args.limit:]
    print(f"# {data.get('schema', '?')}  total={data.get('total', '?')} "
          f"dropped={data.get('dropped', '?')} "
          f"capacity={data.get('capacity', '?')}  "
          f"showing={len(events)}")
    for e in events:
        print(_fmt(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
