"""Process-level helpers.

``retry_with_backoff`` (the engine's guarded launch) and ``is_chief``
(the train hooks' writer rule); the process-group half of the JAX
package's ``core/dist.py`` comes with multi-rank data parallelism
(ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger(__name__)


def is_chief() -> bool:
    """Rank 0 of ``torch.distributed`` when a process group is
    initialised, else True: the one process that writes logs and files.
    Chief-ness affects host-side IO only; every rank runs the same step."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def retry_with_backoff(
    fn,
    *,
    attempts: int = 3,
    base_delay_s: float = 1.0,
    max_delay_s: float = 30.0,
    retry_on: tuple[type[BaseException], ...] = (RuntimeError, OSError),
    sleep=None,
    what: str = "operation",
):
    """Call ``fn()`` up to ``attempts`` times with exponential backoff.

    Delay doubles per attempt from ``base_delay_s`` up to ``max_delay_s``
    — deterministic, no jitter. The last failure re-raises unchanged.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    sleep = time.sleep if sleep is None else sleep
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt + 1 >= attempts:
                raise
            delay = min(base_delay_s * 2 ** attempt, max_delay_s)
            log.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.1fs",
                what, attempt + 1, attempts, e, delay,
            )
            sleep(delay)
