"""Process-level helpers the serving slice needs.

Only ``retry_with_backoff`` so far (the engine's guarded launch); the
process-group half of the JAX package's ``core/dist.py`` comes with the
data-parallel slice.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger(__name__)


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
