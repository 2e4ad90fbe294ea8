"""Host scheduler (``serve/scheduler.py``, ``serve/paged_cache.py``) and
the closed loop's own bookkeeping: the window's host time outside the
engine's launches, (window - the sum of ``last_tick_s``) over ticks, ms.
Moves ``serve_tokens_per_s``."""


def read(run):
    if not run.get("ticks"):
        return None
    inside = sum(run["tick_s"].values())
    return 1e3 * (run["window_s"] - inside) / run["ticks"]
