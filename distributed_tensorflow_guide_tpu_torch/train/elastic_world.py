"""Elastic world-size supervision — capacity management over the
resilience layer.

The JAX package's ``train/elastic_world.py``; generations run through the
port's ``runtime/multiprocess.py`` (gloo ranks, one per process, a
slice a contiguous block of ranks).

:func:`~.elastic.run_with_recovery` is crash-*recovery*: restore
and replay at the SAME world size, so a lost slice keeps the run down
until that capacity returns. This module turns the same machinery into
capacity *management*: a host-side :class:`ElasticSupervisor` runs the job
as a sequence of **generations**, each a real multi-process launch
(runtime/multiprocess.py) at the currently-available world size. On a
``slice_loss`` fault (testing/chaos.py world kinds — the deterministic
stand-in for a coordinator heartbeat failure or process-group exit) the
doomed slice's processes die abruptly, the survivors are reaped, and the
next generation re-forms at the reduced world, restores through the
checkpoint ladder, and continues. On ``slice_return`` the running
generation stops cleanly at the boundary (saving a checkpoint there) and
the next one regrows to full world — its first outer sync re-anchors
every slice.

Data correctness across a resize is the load-bearing contract:

* The stream is **globally step-keyed** — round ``r`` consumes global
  batch ``r``, generated deterministically from ``(seed, r, k)``
  regardless of world size (the ``(seed, epoch, index)`` contract of
  the JAX package's native loader applied to the synthetic stream).
* A resize only changes *who* consumes which contiguous rows
  (:func:`shard_bounds`), never *which* rows round ``r`` consumes — so
  the global batch (and the gradient it defines) is world-size-invariant.
* Replay accounting is inherited from ``run_with_recovery``: a crashed
  generation's post-checkpoint work is discarded and re-executed, so the
  *final trajectory* consumes every round exactly once.
  :func:`verify_stream_accounting` checks exactly that from the per-round
  consumption records every slice leader appends — for each round, the
  records of its final (surviving) execution must tile ``[0, B)``
  disjointly.

What elasticity does NOT guarantee: the reduced-world trajectory is not
bitwise-equal to the uninterrupted full-world one (the outer average runs
over fewer slices, with different per-slice row blocks and a different fp
reduction shape). What IS pinned: two identical seeded elastic runs are
bitwise identical to each other, and the accounting shows zero dropped
or duplicated samples (``tests/test_torch_multislice.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Sequence

log = logging.getLogger("dtg.train")

# the abrupt exit code of a slice_loss casualty — distinguishable from a
# genuine worker bug in the supervisor's post-mortem
EXIT_SLICE_LOST = 77


def shard_bounds(total: int, n_parts: int, rank: int) -> tuple[int, int]:
    """Contiguous row block of ``rank`` when ``total`` rows split over
    ``n_parts`` — ``np.array_split`` bounds, so every world size tiles
    ``[0, total)`` disjointly even when the division is ragged. This is
    the deterministic re-split: a resize changes only these bounds."""
    if not 0 <= rank < n_parts:
        raise ValueError(f"rank {rank} outside [0, {n_parts})")
    return (rank * total) // n_parts, ((rank + 1) * total) // n_parts


def verify_stream_accounting(
    records: Sequence[dict], total_steps: int, global_batch: int
) -> tuple[bool, list[str]]:
    """Check the exactly-once contract from slice-leader consumption
    records ``{"gen", "round", "slice", "lo", "hi"}`` (file order
    preserved per leader).

    For each round, only its FINAL execution contributed to the final
    state: records of the highest generation that executed it, and within
    that generation the last record per slice (an in-generation restart
    replays the round in the same file, later record wins). Those
    intervals must tile ``[0, global_batch)`` disjointly — any gap is a
    silently dropped sample, any overlap a duplicated one."""
    by_round: dict[int, list[dict]] = {}
    for rec in records:
        by_round.setdefault(int(rec["round"]), []).append(rec)
    problems: list[str] = []
    for r in range(total_steps):
        recs = by_round.get(r)
        if not recs:
            problems.append(f"round {r}: never consumed")
            continue
        gen_max = max(int(x["gen"]) for x in recs)
        final: dict[int, tuple[int, int]] = {}
        for x in recs:  # file order: later execution overrides
            if int(x["gen"]) == gen_max:
                final[int(x["slice"])] = (int(x["lo"]), int(x["hi"]))
        pos = 0
        for lo, hi in sorted(final.values()):
            if lo > pos:
                problems.append(
                    f"round {r}: rows [{pos}, {lo}) dropped")
            elif lo < pos:
                problems.append(
                    f"round {r}: rows [{lo}, {pos}) duplicated")
            pos = max(pos, hi)
        if pos != global_batch:
            problems.append(
                f"round {r}: rows [{pos}, {global_batch}) dropped")
    return (not problems, problems)


# ---- worker side ------------------------------------------------------------


class SliceLossHook:
    """The ``slice_loss`` mechanism: after completing step ``position``
    (and after the CheckpointHook at that boundary — run_with_recovery
    orders extra hooks behind it), every process of the doomed slice
    writes a loss marker and dies abruptly (``os._exit``, no atexit
    barriers — a real capacity loss, not a clean shutdown). Surviving
    slices block in their next cross-slice collective and are reaped by
    the runner's failure grace; the supervisor reads the marker to learn
    WHICH slice to drop from the next generation's world."""

    def __init__(self, events: Sequence[tuple[int, int]], workdir: str,
                 slice_id: int, process_id: int):
        # events: (position, slice_id) pairs; only this slice's apply
        self.positions = sorted(
            pos for pos, sl in events if sl == slice_id)
        self.workdir = Path(workdir)
        self.slice_id = slice_id
        self.process_id = process_id

    def begin(self, loop) -> None:
        pass

    def end(self, step: int) -> None:
        pass

    def after_step(self, step: int, metrics) -> None:
        if step in self.positions:
            marker = self.workdir / (
                f"slice_loss_{self.slice_id}_{step}_p{self.process_id}"
                ".marker")
            marker.write_text(json.dumps({
                "slice": self.slice_id, "position": step,
                "process": self.process_id, "t": time.time(),
            }))
            log.warning("chaos: slice %d losing capacity after step %d",
                        self.slice_id, step)
            os._exit(EXIT_SLICE_LOST)


def elastic_toy_worker(spec: dict) -> dict:
    """Multi-process target: two-tier training on slices under the
    elastic supervisor's generation spec. The workload is a linear
    regression: the supervision machinery is under test, not the model.

    ``spec`` (JSON, supervisor-built): live_slices, procs_per_slice,
    generation, stop_at, total_steps, ckpt_every, loss_events
    ``[(position, slice_id), ...]``, sync_period, global_batch, dim,
    seed, inner_lr, outer_lr, outer_momentum, ckpt_dir, workdir, device
    (None or "cuda": every rank on this host's card, which must exist;
    "cpu" only when the caller asks for it).
    """
    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.bridge import (
        regression_to_flax,
    )
    from distributed_tensorflow_guide_tpu_torch.core.device import (
        resolve_device,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import MeshSpec
    from distributed_tensorflow_guide_tpu_torch.parallel.multislice import (
        MultiSliceLocalSGD,
        two_tier_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
        Checkpointer,
    )
    from distributed_tensorflow_guide_tpu_torch.train.elastic import (
        run_with_recovery,
    )
    from distributed_tensorflow_guide_tpu_torch.train.hooks import (
        StopAtStepHook,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import (
        TrainState,
    )

    pid = dist.get_rank() if dist.is_initialized() else 0
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pps = int(spec["procs_per_slice"])
    live = [int(s) for s in spec["live_slices"]]
    n_live = len(live)
    slice_rank = pid // pps
    slice_id = live[slice_rank]
    batch = int(spec["global_batch"])
    if n_proc % n_live or batch % n_proc:
        raise ValueError(
            f"global_batch {batch} must divide over {n_proc} ranks in "
            f"{n_live} slices")
    device = resolve_device(spec.get("device"))

    mesh = two_tier_mesh(MeshSpec(), n_slices=n_live)
    strat = MultiSliceLocalSGD(
        mesh, int(spec["sync_period"]),
        outer_lr=float(spec["outer_lr"]),
        outer_momentum=float(spec["outer_momentum"]), device=device)

    dim = int(spec["dim"])
    k_inner = int(spec["sync_period"])
    seed = int(spec["seed"])
    gt = np.random.RandomState(seed)
    w_true = gt.randn(dim, 1).astype(np.float32)

    def loss_fn(module, sub):
        pred = sub["x"] @ module.weight.t()
        return ((pred - sub["y"]) ** 2).mean(), {}

    model = torch.nn.Linear(dim, 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    model = model.to(device)
    state0 = strat.replicate(strat.init(TrainState(
        model, torch.optim.SGD(model.parameters(),
                               lr=float(spec["inner_lr"])))))

    slo, shi = shard_bounds(batch, n_live, slice_rank)
    leader = pid % pps == 0
    workdir = Path(spec["workdir"])
    acct_path = workdir / f"acct_g{spec['generation']}_p{pid}.jsonl"

    def global_superbatch(r: int):
        xs = []
        for k in range(k_inner):
            rng = np.random.RandomState(
                np.asarray([seed, r, k], dtype=np.uint32))
            xs.append(rng.randn(batch, dim).astype(np.float32))
        x = np.stack(xs)
        return x, x @ w_true

    def make_data(start: int):
        def gen():
            with acct_path.open("a") as fh:
                for r in range(start, 10 ** 9):
                    if leader:
                        fh.write(json.dumps({
                            "gen": int(spec["generation"]), "round": r,
                            "slice": slice_id, "lo": slo, "hi": shi,
                            "t": time.time(),
                        }) + "\n")
                        fh.flush()
                    x, y = global_superbatch(r)
                    # this rank's contiguous rows: shard_bounds(batch,
                    # n_proc, pid), slices outermost
                    yield strat.shard_batch({"x": x, "y": y})

        return gen()

    step = strat.make_train_step(loss_fn)
    ckpt = Checkpointer(spec["ckpt_dir"], max_to_keep=3)
    resumed_from = ckpt.latest_step() or 0
    loss_hook = SliceLossHook(
        [(int(p), int(s)) for p, s in spec.get("loss_events", ())],
        spec["workdir"], slice_id, pid)
    try:
        # run_with_recovery's CheckpointHook saves at the clean stop
        # boundary (its end() hook), so the next generation, typically a
        # regrow, resumes exactly at stop_at; that end save is also a
        # collective, so a survivor of a slice loss can never drift past
        # the dead slice into a false clean exit
        final = run_with_recovery(
            step, state0, make_data, ckpt,
            hooks=[StopAtStepHook(int(spec["stop_at"])), loss_hook],
            checkpoint_every=int(spec["ckpt_every"]),
            max_restarts=2, device=device)
    finally:
        ckpt.close()
    return {
        "pid": pid,
        "slice": slice_id,
        "live": live,
        "resumed_from": resumed_from,
        # the JAX worker's (dim, 1) layout, flattened
        "w": regression_to_flax(final.inner.model.state_dict())["w"]
        .reshape(-1).tolist(),
        "outer_momentum": regression_to_flax(final.outer_momentum)["w"]
        .reshape(-1).tolist(),
    }


# ---- supervisor side --------------------------------------------------------


class ElasticWorldError(RuntimeError):
    pass


@dataclasses.dataclass
class ElasticReport:
    """What a supervised elastic run produced."""

    results: list  # final generation's ProcessResult list
    timeline: list[dict]  # one entry per generation: live set + outcome
    mttr_s: list[float]  # wall-clock per slice-loss resize
    records: list[dict]  # merged slice-leader consumption records
    markers: list[dict]  # slice-loss markers, as written by the casualties

    @property
    def final_params(self) -> list[float]:
        return self.results[0].result["w"]

    def accounting(self, total_steps: int, global_batch: int):
        return verify_stream_accounting(
            self.records, total_steps, global_batch)


def toy_spec(*, total_steps: int, ckpt_every: int = 4, sync_period: int = 1,
             global_batch: int = 8, dim: int = 4, seed: int = 0,
             inner_lr: float = 0.05, outer_lr: float = 1.0,
             outer_momentum: float = 0.0) -> dict:
    """Base spec for :func:`elastic_toy_worker` (the supervisor fills in
    the per-generation fields)."""
    return dict(total_steps=total_steps, ckpt_every=ckpt_every,
                sync_period=sync_period, global_batch=global_batch,
                dim=dim, seed=seed, inner_lr=inner_lr, outer_lr=outer_lr,
                outer_momentum=outer_momentum)


class ElasticSupervisor:
    """Run a job as world-size generations over the multiprocess runner.

    Each generation launches ``len(live_slices) * procs_per_slice``
    processes of ``target`` (default :func:`elastic_toy_worker`) with a
    generation spec; the worker restores through the checkpoint ladder and
    trains toward ``stop_at``. Scheduled ``slice_loss`` faults end a
    generation abruptly (casualties exit, survivors are reaped within
    ``failure_grace``); ``slice_return`` faults end one cleanly at the
    boundary so the next generation regrows. The supervisor owns the
    one-shot bookkeeping: world faults are consumed via
    ``FaultSchedule.fire`` exactly once, so two identically-seeded runs
    follow the identical world timeline — which, with the step-keyed
    stream and crash-only restores, makes them bitwise identical
    (``tests/test_torch_elastic_world.py``). ``device`` goes to every
    worker's spec: ``None`` (the default) puts each worker on this host's
    card and raises there when there is none; ``"cpu"`` is the caller's
    explicit choice.
    """

    def __init__(
        self,
        schedule,  # testing.chaos.FaultSchedule holding the world kinds
        *,
        n_slices: int,
        procs_per_slice: int = 1,
        base_spec: dict,
        ckpt_dir: str | Path,
        workdir: str | Path,
        target: Any = "distributed_tensorflow_guide_tpu_torch.train."
                      "elastic_world:elastic_toy_worker",
        timeout: float = 240.0,
        failure_grace: float = 6.0,
        max_generations: int = 8,
        device: str | None = None,
    ):
        if n_slices < 1:
            raise ValueError("need at least one slice")
        self.schedule = schedule
        self.n_slices = n_slices
        self.pps = procs_per_slice
        self.base_spec = dict(base_spec, device=device)
        self.ckpt_dir = str(ckpt_dir)
        self.workdir = Path(workdir)
        self.target = target
        self.timeout = timeout
        self.failure_grace = failure_grace
        self.max_generations = max_generations
        self.total_steps = int(self.base_spec["total_steps"])
        self.generation_s: list[float] = []  # wall seconds a generation

    # -- helpers -------------------------------------------------------------

    def _scan_markers(self) -> list[dict]:
        out = []
        for p in sorted(self.workdir.glob("slice_loss_*.marker")):
            try:
                out.append(json.loads(p.read_text()))
            except (OSError, json.JSONDecodeError):  # mid-write scan
                continue
        return out

    def read_accounting(self) -> list[dict]:
        """All slice-leader consumption records, file order preserved
        (one leader writes one file per generation — within a (gen,
        slice) the later line is the later execution)."""
        def _order(p: Path) -> tuple[int, int]:
            g, _, pid = p.stem.removeprefix("acct_g").partition("_p")
            return int(g), int(pid)  # numeric: "g10" must not sort < "g2"

        records = []
        for p in sorted(self.workdir.glob("acct_g*_p*.jsonl"), key=_order):
            for line in p.read_text().splitlines():
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:  # torn final line of a kill
                    continue
        return records

    # -- the generation loop -------------------------------------------------

    def run(self) -> ElasticReport:
        from distributed_tensorflow_guide_tpu_torch.runtime import (
            multiprocess,
        )

        self.workdir.mkdir(parents=True, exist_ok=True)
        lost: set[int] = set()
        seen_markers: set[tuple[int, int]] = set()
        timeline: list[dict] = []
        crash_boundaries: list[int] = []  # generation index of each loss
        final_results = None
        gen = 0
        while True:
            if gen >= self.max_generations:
                raise ElasticWorldError(
                    f"no convergence after {gen} generations "
                    f"(timeline: {timeline})")
            live = sorted(set(range(self.n_slices)) - lost)
            if not live:
                raise ElasticWorldError("every slice is lost")
            events = self.schedule.world_events()
            returns = [f for f in events
                       if f.kind == "slice_return" and f.slice_id in lost]
            stop_at = self.total_steps
            if returns:
                stop_at = min(stop_at,
                              min(f.position for f in returns))
            losses = [f for f in events
                      if f.kind == "slice_loss"
                      and f.slice_id not in lost and f.position < stop_at]
            spec = dict(self.base_spec)
            spec.update(
                generation=gen,
                live_slices=live,
                procs_per_slice=self.pps,
                stop_at=stop_at,
                loss_events=[[f.position, f.slice_id] for f in losses],
                ckpt_dir=self.ckpt_dir,
                workdir=str(self.workdir),
            )
            log.info("elastic generation %d: slices %s -> step %d "
                     "(%d pending loss event(s))",
                     gen, live, stop_at, len(losses))
            runner = multiprocess.MultiProcessRunner(
                self.target, len(live) * self.pps, args=(spec,),
                timeout=self.timeout,
            )
            t0 = time.perf_counter()
            results = runner.start().join(
                raise_on_error=False, failure_grace=self.failure_grace)
            self.generation_s.append(time.perf_counter() - t0)
            new = [m for m in self._scan_markers()
                   if (m["slice"], m["position"]) not in seen_markers]
            if new:
                fired = sorted({(m["slice"], m["position"]) for m in new})
                seen_markers |= set(fired)
                for slice_id, pos in fired:
                    lost.add(slice_id)
                    for f in self.schedule.world_events():
                        if (f.kind == "slice_loss"
                                and f.slice_id == slice_id
                                and f.position == pos):
                            self.schedule.fire(f)
                crash_boundaries.append(gen)
                timeline.append({"generation": gen, "live": live,
                                 "stop_at": stop_at,
                                 "outcome": "slice_loss",
                                 "lost": [s for s, _ in fired]})
                log.warning("elastic: slice(s) %s lost; continuing at "
                            "world %s", [s for s, _ in fired],
                            sorted(set(live) - lost))
            else:
                bad = [r for r in results if not r.ok]
                if bad:
                    detail = "\n".join(
                        f"--- process {r.rank} (exit "
                        f"{r.returncode}) ---\n{r.stderr[-2000:]}"
                        for r in bad)
                    raise ElasticWorldError(
                        f"generation {gen} failed without a scheduled "
                        f"slice loss:\n{detail}")
                timeline.append({"generation": gen, "live": live,
                                 "stop_at": stop_at, "outcome": "clean"})
                returned = [f for f in self.schedule.world_events()
                            if f.kind == "slice_return"
                            and f.slice_id in lost
                            and f.position == stop_at]
                for f in returned:
                    lost.discard(f.slice_id)
                    self.schedule.fire(f)
                    timeline[-1]["returned"] = timeline[-1].get(
                        "returned", []) + [f.slice_id]
                if stop_at >= self.total_steps:
                    final_results = results
                    break
            gen += 1
        leftover = self.schedule.world_events()
        if leftover:
            # a loss whose position landed behind a later restore point
            # (scheduled for a slice that was lost when its step went by)
            # can never fire — surface it instead of ending silently, so
            # a test asserting "every fault fired" fails loudly here, not
            # at a confusing downstream assert
            log.warning(
                "elastic run finished with %d world fault(s) still "
                "pending (positions already passed or beyond "
                "total_steps): %s", len(leftover), leftover)
        records = self.read_accounting()
        mttr = self._mttr(records, crash_boundaries)
        return ElasticReport(
            results=final_results, timeline=timeline, mttr_s=mttr,
            records=records, markers=self._scan_markers())

    def _mttr(self, records: Sequence[dict],
              crash_boundaries: Sequence[int]) -> list[float]:
        """Per-resize recovery time: wall clock from the crashed
        generation's last consumed round to the reduced world's first —
        relaunch + handshake + restore ladder + first-round recompile,
        i.e. the real cost of the resize."""
        by_gen: dict[int, list[float]] = {}
        for r in records:
            by_gen.setdefault(int(r["gen"]), []).append(float(r["t"]))
        out = []
        for g in crash_boundaries:
            if g in by_gen and (g + 1) in by_gen:
                out.append(round(min(by_gen[g + 1]) - max(by_gen[g]), 4))
        return out
