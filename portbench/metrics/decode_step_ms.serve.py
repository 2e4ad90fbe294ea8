"""Serve entry and CUDA graphs (``serve/engine.py`` ``_Step``,
``core/graphs.py``): the mean host-clock ``last_tick_s`` of the window's
decode ticks (inputs, replay, token readback), ms. Moves
``serve_tokens_per_s``."""


def read(run):
    n = run["tick_n"].get("decode", 0)
    return 1e3 * run["tick_s"]["decode"] / n if n else None
