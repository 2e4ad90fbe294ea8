"""Train entry (``train/loop.py``, ``parallel/data_parallel.py``): host
time between consecutive step calls, ms a call: ``DispatchStats.
host_gap_s`` over ``dispatches`` across the window. Moves
``train_step_ms``."""


def read(run):
    if not run.get("dispatches"):
        return None
    return 1e3 * run["host_gap_s"] / run["dispatches"]
