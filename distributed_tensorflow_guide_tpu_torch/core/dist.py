"""Process-level helpers: the process group's bootstrap, ``is_chief`` and
``retry_with_backoff``.

The JAX package joins its hosts with one ``jax.distributed.initialize()``
handshake. Here every rank is a process, and the handshake is
``torch.distributed.init_process_group`` over a TCP store at
``MASTER_ADDR:MASTER_PORT``. ``launch.py`` and ``runtime/multiprocess.py``
set ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` for every process they start.

Backend: NCCL when every rank of this host has a card of its own, gloo
otherwise (CPU tensors, or several ranks sharing one card: NCCL refuses two
ranks on one device). A caller may pass ``backend="gloo"`` on a machine
with cards; that is then a property of the group the caller built, and
``collectives.py`` moves what gloo cannot carry through host memory.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os
import time

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Where the ranks meet and who this rank is. All fields optional: a
    config without a world size (or with a world of 1) is a single
    process."""

    master_addr: str | None = None
    master_port: int | None = None
    rank: int | None = None
    world_size: int | None = None
    local_rank: int | None = None
    local_world_size: int | None = None

    @classmethod
    def from_env(cls) -> "DistConfig":
        """Read MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK and
        LOCAL_WORLD_SIZE."""
        env = os.environ

        def num(name):
            return int(env[name]) if name in env else None

        return cls(master_addr=env.get("MASTER_ADDR"),
                   master_port=num("MASTER_PORT"), rank=num("RANK"),
                   world_size=num("WORLD_SIZE"),
                   local_rank=num("LOCAL_RANK"),
                   local_world_size=num("LOCAL_WORLD_SIZE"))

    @property
    def single_process(self) -> bool:
        return self.world_size is None or self.world_size == 1


def default_backend(config: DistConfig) -> str:
    """NCCL when every rank on this host has a card of its own, else
    gloo."""
    import torch

    local_world = config.local_world_size or config.world_size or 1
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


# the TCP store at (MASTER_ADDR, MASTER_PORT) and how many groups have been
# formed over it: rank 0 serves the store for the life of the process, so
# a re-formed group meets over the same store under a fresh key prefix
# instead of racing the old server for its port
_STORE: dict = {"where": None, "store": None, "groups": 0}


def _tcp_store(config: DistConfig, timeout: datetime.timedelta):
    import torch.distributed as dist

    where = (config.master_addr, config.master_port)
    if _STORE["where"] != where:
        store = dist.TCPStore(config.master_addr, config.master_port,
                              config.world_size,
                              is_master=config.rank == 0, timeout=timeout,
                              wait_for_workers=False)
        _STORE.update(where=where, store=store)
    return _STORE["store"]


def initialize(config: DistConfig | None = None, *,
               backend: str | None = None, timeout_s: float = 300.0) -> bool:
    """Join the process group. Idempotent; a single process is a no-op.

    ``config`` defaults to :meth:`DistConfig.from_env`; ``backend`` to
    :func:`default_backend`. The handshake runs under
    :func:`retry_with_backoff` (``DTG_INIT_RETRIES``,
    ``DTG_INIT_BACKOFF_S``): a rank whose store comes up late is not fatal.
    Returns True when a group of more than one rank is (now) initialised.
    """
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    config = config if config is not None else DistConfig.from_env()
    if config.single_process:
        log.debug("single-process run; no process group")
        return False
    missing = [f for f in ("master_addr", "master_port", "rank")
               if getattr(config, f) is None]
    if missing:
        raise ValueError(f"a world of {config.world_size} ranks needs "
                         f"{missing} (MASTER_ADDR, MASTER_PORT, RANK)")
    backend = backend or default_backend(config)
    if backend == "nccl":
        torch.cuda.set_device(config.local_rank or 0)
    timeout = datetime.timedelta(seconds=timeout_s)
    if _STORE["where"] != (config.master_addr, config.master_port):
        _STORE["groups"] = 0
    _STORE["groups"] += 1
    prefix = f"dtg/{_STORE['groups']}/"

    def join():
        store = dist.PrefixStore(prefix, _tcp_store(config, timeout))
        dist.init_process_group(backend, store=store, rank=config.rank,
                                world_size=config.world_size,
                                timeout=timeout)

    retry_with_backoff(
        join, attempts=int(os.environ.get("DTG_INIT_RETRIES", "3")),
        base_delay_s=float(os.environ.get("DTG_INIT_BACKOFF_S", "1.0")),
        what="init_process_group")
    atexit.unregister(shutdown)  # registered once, however often joined
    atexit.register(shutdown)
    log.info("process group: rank %d/%d, backend %s", config.rank,
             config.world_size, backend)
    return True


def reinitialize(config: DistConfig | None = None, *,
                 backend: str | None = None,
                 timeout_s: float = 300.0) -> bool:
    """Destroy the process group and form it again (the in-process elastic
    resize: the survivors re-form the world at its new size). Not
    idempotent: every call cycles the handshake. Groups made from the old
    world (a mesh's axes) are gone with it; build the mesh again."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return initialize(config, backend=backend, timeout_s=timeout_s)


def shutdown() -> None:
    """Destroy the process group, then release the store. :func:`initialize`
    registers it to run at exit: a rank that left both to the
    interpreter's teardown sometimes aborted after its work was done
    (SIGABRT, ``terminate called without an active exception``: a C++
    thread object destroyed while still running) when several gloo jobs
    ran on one host at once."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE.update(where=None, store=None, groups=0)


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
