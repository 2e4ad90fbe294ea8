"""Deterministic chaos harness — seeded fault injection for the resilience
layer.

The reference guide's failure story was untested because failures were
unproducible: you killed a PS by hand and watched workers hang. This module
makes every failure class the resilience layer claims to handle injectable
*deterministically* — a seeded :class:`FaultSchedule` fires the same faults
at the same points on every run — so tests can assert the strongest
property there is: a faulted supervised run ends **bitwise identical** to an
uninterrupted one (``tests/test_torch_chaos.py``; on the card, phases 30-32
of ``chip_smoke.py``).

The schedules are pure data drawn from ``np.random.RandomState(seed)`` in
the JAX package's order, so a seed gives the port the reference's faults,
fault for fault. The fleet kinds are scheduled here and applied by
``serve/fleet.py``'s ``FleetScheduler`` (on the card, phase 35 of
``chip_smoke.py``).

Fault classes and where they fire:

==================  =========================================================
``step_exception``  raised from inside the step function at the Nth step-fn
                    invocation (``wrap_step``) — a host-visible step crash
``nan_batch``       the batch at absolute stream position N is replaced with
                    NaNs (``inject_data``) — data poison for the sentinel
``iterator_stall``  the fetch of position N sleeps ``param`` seconds
                    (``inject_data``) — the watchdog's prey
``ckpt_truncate``   the newest committed checkpoint's largest payload file is
                    truncated when position N is reached (``inject_data``) —
                    post-commit corruption for the restore ladder
``ckpt_corrupt``    same, but bytes are flipped in place (size unchanged —
                    only the CRC manifest can catch it)
==================  =========================================================

World-kind faults are *process-group-targeted* — they change the capacity
of the job instead of poisoning its stream — and fire through the elastic
supervisor (train/elastic_world.py) rather than the step/data injectors:

==================  =========================================================
``slice_loss``      every process of slice ``param`` exits abruptly after
                    completing step N — a lost slice (maintenance, preempted
                    capacity); survivors resume at reduced world size
``slice_return``    slice ``param`` becomes schedulable again at step N —
                    the supervisor regrows to full world at that boundary
==================  =========================================================

Serve-kind faults target the continuous-batching engine
(serve/engine.py) and fire at deterministic engine *tick* positions —
the engine drains them via :meth:`FaultSchedule.take_serve` at the top
of each ``step`` call.  Like the world kinds they are excluded from
:meth:`FaultSchedule.random`'s default draw (the training-side
injectors would silently swallow them and existing storms would hang
waiting); draw a serving storm with :meth:`random_serve` instead:

=======================  ====================================================
``serve_step_exception``  the next step launch raises (a transient
                          launch failure); the engine's retry re-runs the
                          SAME tick bitwise
``client_abandon``        a live request is cancelled (``param`` indexes the
                          sorted live rids); slot+blocks free at the next
                          step boundary
``arrival_burst``         ``param`` extra requests arrive at once through the
                          engine's ``burst_factory`` — the admission gate's
                          prey
``pool_pressure``         ``param`` KV blocks vanish from the pool for a few
                          ticks (a co-tenant spike); residents get evicted
                          and must re-prefill
``snapshot_truncate``     the newest committed engine snapshot is truncated
                          (caught by the manifest size check)
``snapshot_corrupt``      same, but bytes flip in place (only the CRC
                          catches it) — the restore ladder falls back
=======================  ====================================================

Fleet-kind faults target the scale-out tier (serve/fleet.py) and fire at
deterministic FLEET tick positions — the fleet drains them via
:meth:`FaultSchedule.take_fleet` at the top of each fleet ``step``.  They
model the failure domain ABOVE one engine: a whole replica dying or
wedging, and the migration seam tearing mid-handoff.  Like the world and
serve kinds they are excluded from :meth:`FaultSchedule.random`'s default
draw and pass through ``wrap_step``/``inject_data`` untouched; draw a
fleet storm with :meth:`random_fleet`:

==================  =========================================================
``replica_crash``   replica ``param`` dies mid-tick with NO orderly
                    ``detach_stream`` (its KV and engine object are gone);
                    ``serve/fleet.py`` rebuilds its residents from the
                    fleet's own admission ledger, in the replicas'
                    continuation form, and re-anchors them queue-front
``replica_stall``   replica ``param`` wedges (the watchdog's tick-deadline
                    verdict, delivered deterministically); it is excluded
                    from routing while its streams re-anchor host-side,
                    and rejoins after the fleet's stall-recovery window
``migration_torn``  the NEXT migration / re-anchor handoff record is
                    duplicated in flight (a torn handoff: the sender
                    cannot know the record landed, so it resends) — the
                    fleet's (rid, generation) adoption ledger must swallow
                    the duplicate exactly once
==================  =========================================================

Mid-save process kills are process-level, not stream-level: use
``runtime.multiprocess.MultiProcessRunner.kill`` directly (see the chaos
tests). Every fault is one-shot — after it fires once it never fires again,
which is what makes replay-after-recovery converge (and is also how real
transients behave; persistent data poison is modeled by the underlying
stream itself, plus the sentinel's ``skip_offending``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events

log = logging.getLogger("dtg.chaos")

DATA_KINDS = ("nan_batch", "iterator_stall", "ckpt_truncate", "ckpt_corrupt")
STEP_KINDS = ("step_exception",)
# in-process injectable kinds — what wrap_step/inject_data (and
# FaultSchedule.random's default draw) cover
INJECTABLE_KINDS = STEP_KINDS + DATA_KINDS
# world kinds change job capacity; they are applied by the elastic
# supervisor (train/elastic_world.py), which marks them fired via fire()
WORLD_KINDS = ("slice_loss", "slice_return")
# serve storm kinds fire inside ServeEngine.step at engine-tick
# positions; the snapshot kinds additionally need an engine snapshot
# directory to damage, so random_serve leaves them out of its default
# draw the same way random() leaves out the ckpt-less-safe split
SERVE_STORM_KINDS = ("serve_step_exception", "client_abandon",
                     "arrival_burst", "pool_pressure")
SERVE_SNAPSHOT_KINDS = ("snapshot_truncate", "snapshot_corrupt")
SERVE_KINDS = SERVE_STORM_KINDS + SERVE_SNAPSHOT_KINDS
# fleet kinds fire inside FleetScheduler.step at fleet-tick positions —
# the replica-targeted ones carry a replica index in param (mod'd by the
# fleet width, mirroring the world kinds' slice targeting)
FLEET_KINDS = ("replica_crash", "replica_stall", "migration_torn")
KINDS = INJECTABLE_KINDS + WORLD_KINDS + SERVE_KINDS + FLEET_KINDS


class ChaosInjectedError(RuntimeError):
    """The injected step exception (recoverable by design)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``position`` is the absolute stream position for
    data-kind faults, the (1-based counting from 0) step-fn invocation index
    for ``step_exception``. ``param`` is kind-specific: stall seconds for
    ``iterator_stall``, unused otherwise."""

    kind: str
    position: int
    param: float = 0.0
    # arrival_burst only: direct the burst at one tenant so fair-share
    # admission (not just queue shedding) is what absorbs it
    tenant: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {KINDS})")
        if self.tenant is not None:
            if self.kind != "arrival_burst":
                raise ValueError(
                    f"tenant= only applies to arrival_burst, not "
                    f"{self.kind!r}")
            if self.tenant != int(self.tenant) or self.tenant < 0:
                raise ValueError(
                    f"arrival_burst tenant must be a non-negative id, "
                    f"got {self.tenant!r}")
        if self.kind in WORLD_KINDS:
            # param targets the process group: the slice index
            if self.param != int(self.param) or self.param < 0:
                raise ValueError(
                    f"{self.kind} needs param = a non-negative slice "
                    f"index, got {self.param!r}")
        if self.kind == "client_abandon":
            # param indexes the engine's sorted live rids (mod count)
            if self.param != int(self.param) or self.param < 0:
                raise ValueError(
                    f"client_abandon needs param = a non-negative live-rid "
                    f"index, got {self.param!r}")
        if self.kind in ("arrival_burst", "pool_pressure"):
            if self.param != int(self.param) or self.param < 1:
                raise ValueError(
                    f"{self.kind} needs param = a positive count "
                    f"(requests / blocks), got {self.param!r}")
        if self.kind in ("replica_crash", "replica_stall"):
            # param targets the replica index (mod fleet width at fire)
            if self.param != int(self.param) or self.param < 0:
                raise ValueError(
                    f"{self.kind} needs param = a non-negative replica "
                    f"index, got {self.param!r}")

    @property
    def slice_id(self) -> int:
        """The targeted slice of a world-kind fault."""
        if self.kind not in WORLD_KINDS:
            raise ValueError(f"{self.kind!r} targets no slice")
        return int(self.param)


def _poison(batch: Any) -> Any:
    """Replace every float leaf with NaNs (ints/bools pass through): a
    tensor keeps its device and dtype, a numpy array its dtype."""
    from torch.utils import _pytree

    def bad(x):
        if isinstance(x, torch.Tensor):
            return (torch.full_like(x, float("nan"))
                    if x.is_floating_point() else x)
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.floating):
            return np.full_like(arr, np.nan)
        return x

    return _pytree.tree_map(bad, batch)


def _interruptible_sleep(seconds: float) -> None:
    """Sleep in small slices so a watchdog ``interrupt_main`` can land
    between bytecodes — a single long C-level sleep would be opaque to it
    (the honest limitation utils/watchdog.py documents)."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        time.sleep(0.02)


def corrupt_checkpoint(directory: str | Path, step: int | None = None, *,
                       mode: str = "truncate") -> tuple[int, str]:
    """Damage a committed checkpoint in place — the post-commit corruption
    (partial fsync loss, bit rot, an overzealous cleanup job) the manifest
    + restore ladder exist for.

    ``mode="truncate"`` halves the largest payload file (size changes —
    caught by the manifest's size check); ``mode="flip"`` inverts its
    middle bytes (size unchanged — only the CRC catches it). ``step=None``
    targets the newest committed step. Returns ``(step, relative_path)``.
    """
    directory = Path(directory)
    steps = sorted(
        int(p.name) for p in directory.iterdir()
        if p.is_dir() and p.name.isdigit()
    )
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {directory}")
    step = steps[-1] if step is None else step
    step_dir = directory / str(step)
    target = max(
        (p for p in step_dir.rglob("*") if p.is_file()),
        key=lambda p: p.stat().st_size,
    )
    # in place: a checkpoint of a full-size model is gigabytes, and the
    # damage lands inside a data fetch that may run under a deadline
    size = target.stat().st_size
    if mode == "truncate":
        os.truncate(target, size // 2)
    elif mode == "flip":
        mid = size // 2
        span = max(1, min(64, size - mid))
        with target.open("r+b") as fh:
            fh.seek(mid)
            mutated = bytes(b ^ 0xFF for b in fh.read(span))
            fh.seek(mid)
            fh.write(mutated)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    rel = str(target.relative_to(step_dir))
    log.warning("chaos: %s checkpoint step %d file %s", mode, step, rel)
    return step, rel


class FaultSchedule:
    """A seeded, one-shot fault plan shared across a supervised run.

    The SAME instance must wrap both the step function and the data maker
    of every restart attempt (``run_with_recovery`` re-calls ``make_data``
    per attempt; the schedule's fired-set persists across them) — that is
    what makes each fault fire exactly once per run.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults = sorted(faults, key=lambda f: (f.position, f.kind))
        self.fired: list[Fault] = []
        self._pending = set(self.faults)
        self._step_calls = 0
        # every firing lands in the flight recorder as a ``chaos.fault``
        # instant. The serve engine stamps
        # ``recorder``/``obs_now`` with its own recorder and semantic
        # clock each tick; standalone schedules use the process-global
        # recorder (disabled by default) with no semantic timestamp.
        self.recorder = obs_events.current()
        self.obs_now: float | None = None

    @classmethod
    def random(cls, seed: int, *, max_position: int,
               kinds: Sequence[str] = INJECTABLE_KINDS, n_faults: int = 3,
               min_position: int = 1,
               stall_s: float = 0.5) -> "FaultSchedule":
        """Deterministic-in-``seed`` schedule: ``n_faults`` distinct
        positions in ``[min_position, max_position)``, kinds drawn
        uniformly from the INJECTABLE kinds (world kinds need a slice
        target — use :meth:`random_world`). Same seed → identical
        schedule, always."""
        if max_position - min_position < n_faults:
            raise ValueError(
                f"cannot place {n_faults} faults in "
                f"[{min_position}, {max_position})")
        rng = np.random.RandomState(seed)
        positions = rng.choice(
            np.arange(min_position, max_position), size=n_faults,
            replace=False,
        )
        chosen = rng.choice(len(kinds), size=n_faults)
        return cls([
            Fault(kinds[int(k)], int(p),
                  stall_s if kinds[int(k)] == "iterator_stall" else 0.0)
            for p, k in zip(positions, chosen)
        ])

    @classmethod
    def random_world(cls, seed: int, *, n_slices: int, max_position: int,
                     min_position: int = 1, min_gap: int = 2,
                     ) -> "FaultSchedule":
        """Deterministic-in-``seed`` capacity storm: one ``slice_loss`` /
        ``slice_return`` pair targeting a random slice, the loss at a
        random step and the return at least ``min_gap`` steps later (the
        reduced-world window has to contain real training for the elastic
        pins to mean anything). Same seed → identical schedule, always."""
        if n_slices < 2:
            raise ValueError(
                f"need >= 2 slices to lose one, got {n_slices}")
        if max_position - min_position <= min_gap:
            raise ValueError(
                f"cannot place a loss/return pair {min_gap} apart in "
                f"[{min_position}, {max_position})")
        rng = np.random.RandomState(seed)
        target = int(rng.randint(0, n_slices))
        loss_at = int(rng.randint(min_position, max_position - min_gap))
        return_at = int(rng.randint(loss_at + min_gap, max_position))
        return cls([
            Fault("slice_loss", loss_at, float(target)),
            Fault("slice_return", return_at, float(target)),
        ])

    @classmethod
    def random_serve(cls, seed: int, *, max_position: int,
                     kinds: Sequence[str] = SERVE_STORM_KINDS,
                     n_faults: int = 4, min_position: int = 1,
                     burst_n: int = 2, pressure_blocks: int = 4,
                     abandon_span: int = 4,
                     burst_tenants: int | None = None) -> "FaultSchedule":
        """Deterministic-in-``seed`` serving storm: ``n_faults`` distinct
        engine-tick positions in ``[min_position, max_position)``, kinds
        drawn uniformly from ``kinds`` (defaults to the storm kinds — the
        snapshot kinds need ``ServeEngine(snapshot_dir=...)``, so pass
        ``SERVE_KINDS`` explicitly to include them). Params: bursts are
        ``burst_n`` requests, pressure spikes grab ``pressure_blocks``,
        abandons index the live rids in ``[0, abandon_span)``. With
        ``burst_tenants`` set, each arrival_burst additionally targets a
        tenant drawn from ``[0, burst_tenants)`` (rng draws happen only
        for burst faults, so schedules without bursts — or with
        ``burst_tenants=None`` — are byte-identical to pre-tenancy ones).
        Same seed → identical schedule, always."""
        bad = [k for k in kinds if k not in SERVE_KINDS]
        if bad:
            raise ValueError(f"non-serve kinds in random_serve: {bad}")
        if max_position - min_position < n_faults:
            raise ValueError(
                f"cannot place {n_faults} faults in "
                f"[{min_position}, {max_position})")
        rng = np.random.RandomState(seed)
        positions = rng.choice(
            np.arange(min_position, max_position), size=n_faults,
            replace=False,
        )
        chosen = rng.choice(len(kinds), size=n_faults)
        params = {"serve_step_exception": lambda: 0.0,
                  "snapshot_truncate": lambda: 0.0,
                  "snapshot_corrupt": lambda: 0.0,
                  "client_abandon": lambda: float(
                      rng.randint(0, abandon_span)),
                  "arrival_burst": lambda: float(burst_n),
                  "pool_pressure": lambda: float(pressure_blocks)}

        def _tenant(kind):
            if kind != "arrival_burst" or burst_tenants is None:
                return None
            return int(rng.randint(0, burst_tenants))

        faults = []
        for p, k in zip(positions, chosen):
            kind = kinds[int(k)]
            faults.append(Fault(kind, int(p), params[kind](),
                                tenant=_tenant(kind)))
        return cls(faults)

    @classmethod
    def random_fleet(cls, seed: int, *, max_position: int,
                     replicas: int,
                     kinds: Sequence[str] = FLEET_KINDS,
                     n_faults: int = 3,
                     min_position: int = 1) -> "FaultSchedule":
        """Deterministic-in-``seed`` fleet storm: ``n_faults`` distinct
        FLEET-tick positions in ``[min_position, max_position)``, kinds
        drawn uniformly from ``kinds`` (defaults to all three fleet
        kinds).  Replica-targeted kinds draw their target from
        ``[0, replicas)``; ``migration_torn`` is param-free (rng draws
        happen only for replica-targeted faults, keeping schedules with
        different kind mixes independently stable).  Same seed →
        identical schedule, always."""
        bad = [k for k in kinds if k not in FLEET_KINDS]
        if bad:
            raise ValueError(f"non-fleet kinds in random_fleet: {bad}")
        if replicas < 1:
            raise ValueError(f"need >= 1 replica to target, "
                             f"got {replicas}")
        if max_position - min_position < n_faults:
            raise ValueError(
                f"cannot place {n_faults} faults in "
                f"[{min_position}, {max_position})")
        rng = np.random.RandomState(seed)
        positions = rng.choice(
            np.arange(min_position, max_position), size=n_faults,
            replace=False,
        )
        chosen = rng.choice(len(kinds), size=n_faults)
        faults = []
        for p, k in zip(positions, chosen):
            kind = kinds[int(k)]
            param = (0.0 if kind == "migration_torn"
                     else float(rng.randint(0, replicas)))
            faults.append(Fault(kind, int(p), param))
        return cls(faults)

    @property
    def pending(self) -> list[Fault]:
        return sorted(self._pending, key=lambda f: (f.position, f.kind))

    def world_events(self) -> list[Fault]:
        """Pending world-kind faults, soonest first — the elastic
        supervisor's work queue."""
        return [f for f in self.pending if f.kind in WORLD_KINDS]

    def serve_events(self) -> list[Fault]:
        """Pending serve-kind faults, soonest first — what the engine has
        yet to absorb (tests assert this drains to [] at run end)."""
        return [f for f in self.pending if f.kind in SERVE_KINDS]

    def take_serve(self, tick: int) -> list[Fault]:
        """Consume (one-shot) the serve-kind faults due at engine tick
        ``tick``. The engine calls this at the top of every ``step`` and
        applies what comes back — the mechanism lives in the engine, the
        schedule only decides *when*, mirroring the world-kind split."""
        return self._take(tick, SERVE_KINDS)

    def fleet_events(self) -> list[Fault]:
        """Pending fleet-kind faults, soonest first — what the fleet has
        yet to absorb (tests assert this drains to [] at run end)."""
        return [f for f in self.pending if f.kind in FLEET_KINDS]

    def take_fleet(self, tick: int) -> list[Fault]:
        """Consume (one-shot) the fleet-kind faults due at fleet tick
        ``tick``.  :class:`~..serve.fleet.FleetScheduler` calls this at
        the top of every fleet ``step`` — the mechanism (crash
        reconstruction, stall exclusion, torn-handoff duplication) lives
        in the fleet, the schedule only decides *when*."""
        return self._take(tick, FLEET_KINDS)

    def fire(self, fault: Fault) -> None:
        """Mark an externally-applied fault fired (one-shot bookkeeping
        for the world kinds, whose mechanism lives in the supervisor, not
        in wrap_step/inject_data)."""
        if fault not in self._pending:
            raise ValueError(f"fault {fault} is not pending (already "
                             "fired, or never scheduled)")
        self._pending.discard(fault)
        self.fired.append(fault)
        self._record(fault)

    def _take(self, position: int, kinds: Sequence[str]) -> list[Fault]:
        # kind-sorted, NOT set-iteration order: _pending is a set and
        # Fault.kind is a str, so under hash randomization two faults
        # due at the same position would fire in a process-dependent
        # order (a torn handoff armed before vs after a same-tick crash
        # is a different storm) — sorting makes co-positioned faults
        # deterministic across processes
        due = sorted(
            (f for f in self._pending
             if f.position == position and f.kind in kinds),
            key=lambda f: (f.kind, f.param))
        for f in due:
            self._pending.discard(f)
            self.fired.append(f)
            self._record(f)
        return due

    def _record(self, fault: Fault) -> None:
        if self.recorder.enabled:
            self.recorder.emit(
                "chaos.fault", cat="chaos", actor="schedule",
                payload={"kind": fault.kind, "position": fault.position,
                         "param": fault.param, "tenant": fault.tenant},
                t=self.obs_now)

    # ---- injectors ---------------------------------------------------------

    def wrap_step(self, step_fn: Callable) -> Callable:
        """Raise :class:`ChaosInjectedError` at the scheduled step-fn
        invocation indices (counting every invocation, replays included —
        execution order under a fixed schedule is deterministic, so the
        whole faulted run is too)."""

        def chaotic_step(state, batch):
            call = self._step_calls
            self._step_calls += 1
            for f in self._take(call, STEP_KINDS):
                log.warning("chaos: injected step exception at call %d",
                            call)
                raise ChaosInjectedError(
                    f"chaos: injected step exception (call {call})")
            return step_fn(state, batch)

        return chaotic_step

    def inject_data(self, make_data: Callable[[int], Iterable], *,
                    checkpoint_dir: str | Path | None = None,
                    ) -> Callable[[int], Iterator]:
        """Wrap a ``make_data(start)`` maker: data-kind faults fire when the
        stream reaches their absolute position. Checkpoint-corruption kinds
        need ``checkpoint_dir`` (they damage the newest committed save at
        that moment — i.e. *after* the checkpoints earlier positions
        produced, which is what makes the ladder's fallback observable)."""

        def wrapped(start: int) -> Iterator:
            def gen():
                pos = start
                for batch in make_data(start):
                    for f in self._take(pos, DATA_KINDS):
                        batch = self._fire_data(f, batch, checkpoint_dir)
                    yield batch
                    pos += 1

            return gen()

        return wrapped

    def _fire_data(self, fault: Fault, batch: Any,
                   checkpoint_dir: str | Path | None) -> Any:
        log.warning("chaos: firing %s at position %d",
                    fault.kind, fault.position)
        if fault.kind == "nan_batch":
            return _poison(batch)
        if fault.kind == "iterator_stall":
            _interruptible_sleep(fault.param)
            return batch
        # ckpt_truncate / ckpt_corrupt
        if checkpoint_dir is None:
            raise ValueError(
                f"{fault.kind} fault needs inject_data(checkpoint_dir=...)")
        try:
            corrupt_checkpoint(
                checkpoint_dir,
                mode="truncate" if fault.kind == "ckpt_truncate" else "flip",
            )
        except FileNotFoundError:
            log.warning("chaos: %s at position %d found no committed "
                        "checkpoint to damage", fault.kind, fault.position)
        return batch
