"""Data layer (``data/native_loader.py``, ``data/prefetch.py``): the
host's wait in the upstream iterator a prefetched batch (a pack of k
steps where the step takes k), ms: ``PrefetchStats.host_wait_s`` over
``batches`` across the window. Moves ``train_step_ms``."""


def read(run):
    if not run.get("input_batches"):
        return None
    return 1e3 * run["input_wait_s"] / run["input_batches"]
