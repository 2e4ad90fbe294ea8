"""Serve entry (``serve/engine.py`` ``_run_prefill``): the mean
host-clock ``last_tick_s`` of the window's prefill-chunk ticks, ms. Moves
``ttft_p95_ms``."""


def read(run):
    n = run["tick_n"].get("prefill", 0)
    return 1e3 * run["tick_s"]["prefill"] / n if n else None
