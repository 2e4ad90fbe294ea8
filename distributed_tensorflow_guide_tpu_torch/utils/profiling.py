"""Dispatch / host-gap accounting of a train loop.

How many step calls a run issued, and how much host time elapsed between
them (batch fetch, hook work, Python overhead) and inside them (the host
side of the call: PyTorch queues the device work and returns). The rest
of the JAX package's ``utils/profiling.py`` (trace context, annotations,
memory profiles, ``ProfilerHook``) comes with ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import dataclasses


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
