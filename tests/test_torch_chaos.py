"""The port's chaos harness (``testing/chaos.py``) and supervised recovery
(``train/elastic.run_with_recovery``) held to the JAX package's
``tests/test_chaos.py`` on the CPU.

* Schedules are pure data from ``np.random.RandomState(seed)``: the
  port's ``FaultSchedule.random``, ``random_world``, ``random_serve`` and
  ``random_fleet`` equal the reference's, fault for fault, for seeds
  0-19.
* Crash equivalence, per fault class and for a seeded storm with async
  saves: a faulted supervised run of a tiny LM (2 layers, d=64, Adam; the
  harness of ``tests/torch_mp_workers.py``) ends with parameters, Adam
  moments and step bitwise those of the uninterrupted run.
* The recovery trace (restarts with their error and step, the restored
  steps and the ladder's skipped steps, faults fired, sentinel trips; the
  flight-recorder events both packages emit) of the port's
  ``run_with_recovery`` equals the JAX package's under the same schedule
  on the reference test's problem (toy least squares, sync saves), and
  the clean runs' losses agree within 1e-5.
* The kill-mid-save pin across real processes: a SIGKILL while an async
  save may be mid-write; the next process sweeps the debris, restores the
  newest valid checkpoint and finishes with the uninterrupted result.
"""

import pathlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.obs import events as jevents
from distributed_tensorflow_guide_tpu.testing import chaos as jchaos
from distributed_tensorflow_guide_tpu.train.anomaly import (
    AnomalySentinelHook as JAnomalySentinelHook,
)
from distributed_tensorflow_guide_tpu.train.checkpoint import (
    Checkpointer as JCheckpointer,
)
from distributed_tensorflow_guide_tpu.train.elastic import (
    run_with_recovery as jrun_with_recovery,
)
from distributed_tensorflow_guide_tpu.train.hooks import (
    BaseHook as JBaseHook,
)
from distributed_tensorflow_guide_tpu.train.hooks import (
    StopAtStepHook as JStopAtStepHook,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as tevents
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
    FLEET_KINDS,
    INJECTABLE_KINDS,
    SERVE_KINDS,
    SERVE_SNAPSHOT_KINDS,
    SERVE_STORM_KINDS,
    WORLD_KINDS,
    ChaosInjectedError,
    Fault,
    FaultSchedule,
    corrupt_checkpoint,
)
from distributed_tensorflow_guide_tpu_torch.train import (
    AnomalySentinelHook,
    BaseHook,
    Checkpointer,
    StopAtStepHook,
    run_with_recovery,
)
from tests import torch_mp_workers as W


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run tiny ops: one intra-op thread a worker keeps them
    from spinning against the other test workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOTAL = 12
CKPT_EVERY = 4

# ---- schedules equal the reference's, fault for fault ------------------------

CONSTRUCTORS = {
    "random": lambda m, seed: m.FaultSchedule.random(
        seed, max_position=40, n_faults=5, stall_s=0.7),
    "random_world": lambda m, seed: m.FaultSchedule.random_world(
        seed, n_slices=4, max_position=30),
    "random_serve": lambda m, seed: m.FaultSchedule.random_serve(
        seed, max_position=40, kinds=m.SERVE_KINDS, n_faults=6,
        burst_tenants=3),
    "random_fleet": lambda m, seed: m.FaultSchedule.random_fleet(
        seed, max_position=40, replicas=3),
}


def _faults(sched):
    return [(f.kind, f.position, f.param, f.tenant) for f in sched.faults]


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("ctor", sorted(CONSTRUCTORS))
def test_schedule_equals_the_references(ctor, seed):
    from distributed_tensorflow_guide_tpu_torch.testing import chaos

    assert chaos.KINDS == jchaos.KINDS
    got = _faults(CONSTRUCTORS[ctor](chaos, seed))
    assert got == _faults(CONSTRUCTORS[ctor](jchaos, seed))


def test_schedule_is_deterministic_in_seed():
    a = FaultSchedule.random(7, max_position=50, n_faults=5)
    b = FaultSchedule.random(7, max_position=50, n_faults=5)
    assert a.faults == b.faults
    assert a.faults != FaultSchedule.random(8, max_position=50,
                                            n_faults=5).faults


def _toy_step(state, batch):
    p = state["params"]
    return {"params": p - 0.01 * (2 * p + batch["x"])}, {
        "loss": (p ** 2).sum()}


def _toy_init():
    return {"params": torch.ones(4)}


def _toy_data(start):
    return ({"x": np.full((4,), float(s), np.float32)}
            for s in range(start, 10_000))


def test_schedule_one_shot_semantics():
    sched = FaultSchedule([Fault("step_exception", 2)])
    step = sched.wrap_step(_toy_step)
    state, batch = _toy_init(), {"x": torch.zeros(4)}
    step(state, batch)
    step(state, batch)
    with pytest.raises(ChaosInjectedError):
        step(state, batch)  # call index 2 fires...
    step(state, batch)  # ...exactly once
    assert sched.pending == [] and [f.kind for f in sched.fired] == [
        "step_exception"]


def test_unknown_fault_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor_strike", 3)


def test_ckpt_fault_requires_checkpoint_dir():
    sched = FaultSchedule([Fault("ckpt_truncate", 0)])
    with pytest.raises(ValueError, match="checkpoint_dir"):
        next(sched.inject_data(_toy_data)(0))


def test_nan_batch_poisons_float_leaves_only():
    sched = FaultSchedule([Fault("nan_batch", 0)])
    batch = next(sched.inject_data(
        lambda s: iter([{"tokens": np.arange(4), "x": torch.ones(3),
                         "y": np.ones(2, np.float32)}]))(0))
    np.testing.assert_array_equal(batch["tokens"], np.arange(4))
    assert torch.isnan(batch["x"]).all() and np.isnan(batch["y"]).all()


def test_corrupt_checkpoint_targets_newest_by_default(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck", max_to_keep=5)
    ckpt.save(1, _toy_init())
    ckpt.save(2, _toy_init())
    step, rel = corrupt_checkpoint(tmp_path / "ck")
    assert step == 2 and rel == "state.pt"
    assert not ckpt.verify_step(2) and ckpt.verify_step(1)
    ckpt.close()


def test_corrupt_checkpoint_empty_dir_raises(tmp_path):
    (tmp_path / "nothing").mkdir()
    with pytest.raises(FileNotFoundError):
        corrupt_checkpoint(tmp_path / "nothing")


def test_world_kinds_validate_slice_target():
    assert Fault("slice_loss", 5, 2.0).slice_id == 2
    with pytest.raises(ValueError, match="slice"):
        Fault("slice_return", 5, 1.5)
    with pytest.raises(ValueError, match="slice"):
        Fault("slice_loss", 5, -1.0)
    with pytest.raises(ValueError, match="targets no slice"):
        Fault("step_exception", 5).slice_id


def test_world_events_and_fire_are_one_shot():
    loss = Fault("slice_loss", 3, 1.0)
    ret = Fault("slice_return", 8, 1.0)
    sched = FaultSchedule([loss, Fault("step_exception", 5), ret])
    assert sched.world_events() == [loss, ret]
    sched.fire(loss)
    assert sched.world_events() == [ret] and loss in sched.fired
    with pytest.raises(ValueError, match="not pending"):
        sched.fire(loss)


@pytest.mark.parametrize("faults,pending", [
    ([Fault("slice_loss", 0, 0.0), Fault("slice_return", 1, 0.0)],
     "world_events"),
    ([Fault("serve_step_exception", 0), Fault("client_abandon", 1, 0.0)],
     "serve_events"),
    ([Fault("replica_crash", 0, 0.0), Fault("migration_torn", 1)],
     "fleet_events"),
])
def test_injectors_never_consume_other_kinds(tmp_path, faults, pending):
    sched = FaultSchedule(faults)
    step = sched.wrap_step(_toy_step)
    state = _toy_init()
    data = sched.inject_data(_toy_data, checkpoint_dir=tmp_path)(0)
    for _ in range(3):
        b = next(data)
        state, _ = step(state, {"x": torch.as_tensor(b["x"])})
    assert len(getattr(sched, pending)()) == 2 and not sched.fired


def test_random_world_deterministic_and_ordered():
    a = FaultSchedule.random_world(9, n_slices=4, max_position=30)
    (loss, ret) = a.world_events()
    assert loss.kind == "slice_loss" and ret.kind == "slice_return"
    assert loss.slice_id == ret.slice_id
    assert ret.position >= loss.position + 2


def test_random_default_draws_stay_in_their_kinds():
    for seed in range(8):
        s = FaultSchedule.random(seed, max_position=40, n_faults=5)
        assert all(f.kind in INJECTABLE_KINDS for f in s.faults)
        assert not any(f.kind in WORLD_KINDS + SERVE_KINDS + FLEET_KINDS
                       for f in s.faults)
        s = FaultSchedule.random_serve(seed, max_position=40)
        assert all(f.kind in SERVE_STORM_KINDS for f in s.faults)
        assert not any(f.kind in SERVE_SNAPSHOT_KINDS for f in s.faults)
        s = FaultSchedule.random_fleet(seed, max_position=40, replicas=3)
        assert all(f.kind in FLEET_KINDS and 0 <= f.param < 3
                   for f in s.faults)


def test_serve_and_fleet_kinds_validate_params():
    Fault("serve_step_exception", 3)
    assert Fault("client_abandon", 3, 2.0).param == 2.0
    with pytest.raises(ValueError, match="live-rid"):
        Fault("client_abandon", 3, 1.5)
    with pytest.raises(ValueError, match="positive count"):
        Fault("arrival_burst", 3)
    with pytest.raises(ValueError, match="positive count"):
        Fault("pool_pressure", 3, 0.5)
    Fault("migration_torn", 3)
    with pytest.raises(ValueError, match="replica"):
        Fault("replica_stall", 3, 1.5)
    with pytest.raises(ValueError, match="non-serve"):
        FaultSchedule.random_serve(0, max_position=40,
                                   kinds=("step_exception",))
    with pytest.raises(ValueError, match="non-fleet"):
        FaultSchedule.random_fleet(0, max_position=40, replicas=2,
                                   kinds=("step_exception",))


def test_take_serve_and_take_fleet_are_one_shot():
    f2 = Fault("serve_step_exception", 2)
    f5 = Fault("pool_pressure", 5, 4.0)
    c2 = Fault("replica_crash", 2, 0.0)
    sched = FaultSchedule([f2, f5, c2, Fault("step_exception", 2)])
    assert sched.take_serve(0) == []
    assert sched.take_serve(2) == [f2]
    assert sched.take_serve(2) == []
    assert sched.take_fleet(2) == [c2]
    assert sched.serve_events() == [f5] and sched.fleet_events() == []
    assert any(f.kind == "step_exception" for f in sched.pending)


def test_take_orders_copositioned_faults_deterministically():
    sched = FaultSchedule([Fault("replica_crash", 3, 1.0),
                           Fault("migration_torn", 3),
                           Fault("replica_stall", 3, 0.0)])
    assert [f.kind for f in sched.take_fleet(3)] == [
        "migration_torn", "replica_crash", "replica_stall"]


# ---- crash equivalence on the tiny LM ----------------------------------------


def _supervised(tmpdir, schedule, *, hooks=(), max_restarts=8, **kw):
    state = W.rl_state()
    step = schedule.wrap_step(W.rl_step(state))
    data = schedule.inject_data(W.rl_data, checkpoint_dir=tmpdir)
    ckpt = Checkpointer(tmpdir, max_to_keep=3)
    try:
        return run_with_recovery(
            step, state, data, ckpt,
            hooks=[StopAtStepHook(TOTAL), *hooks],
            checkpoint_every=CKPT_EVERY, max_restarts=max_restarts,
            device="cpu", **kw)
    finally:
        ckpt.close()


@pytest.fixture(scope="module")
def clean_lm():
    return W.rl_oracle(range(TOTAL))


@pytest.mark.parametrize("faults,kw", [
    ([Fault("step_exception", 9)], {}),
    ([Fault("step_exception", 2)], {}),  # before any checkpoint: fresh
    ([Fault("nan_batch", 9)], {"sentinel": True}),
    ([Fault("ckpt_truncate", 9), Fault("step_exception", 10)], {}),
    ([Fault("ckpt_corrupt", 9), Fault("step_exception", 10)], {}),
    ([Fault("iterator_stall", 9, param=1.0)], {"data_deadline_s": 0.25}),
], ids=["step_exception", "step_exception_fresh", "nan_batch",
        "ckpt_truncate", "ckpt_corrupt", "iterator_stall"])
def test_equivalence_per_fault_class(tmp_path, clean_lm, faults, kw):
    sched = FaultSchedule(faults)
    hooks = [AnomalySentinelHook(budget=3)] if kw.pop("sentinel",
                                                      False) else []
    out = _supervised(tmp_path / "c", sched, hooks=hooks, **kw)
    assert sched.pending == [] and len(sched.fired) == len(faults)
    assert W.rl_equal(clean_lm, out)


def test_equivalence_seeded_storm_async(tmp_path, clean_lm):
    sched = FaultSchedule.random(3, max_position=TOTAL - 2, n_faults=4,
                                 min_position=2, stall_s=0.6)
    out = _supervised(tmp_path / "c", sched,
                      hooks=[AnomalySentinelHook(budget=5)],
                      max_restarts=12, async_save=True,
                      data_deadline_s=0.25)
    assert sched.pending == []
    assert W.rl_equal(clean_lm, out)


# ---- the recovery trace against the JAX package's ----------------------------

TRACE_KINDS = ("elastic.restore", "elastic.restart", "ckpt.restore",
               "ckpt.restore_miss", "chaos.fault", "anomaly.trip")
T_TOTAL, T_EVERY = 20, 5


class _Losses:
    def __init__(self):
        self.losses = []

    def begin(self, loop):
        pass

    def after_step(self, step, metrics):
        self.losses.append((step, float(metrics["loss"])))

    def end(self, step):
        pass


def _trace(rec) -> list:
    return [row for row in tevents.signature(rec.events())
            if row[0] in TRACE_KINDS]


def _jax_run(tmpdir, make_faults, sentinel, **kw):
    rec = jevents.FlightRecorder()
    prev = jevents.install(rec)
    try:
        sched = jchaos.FaultSchedule(make_faults())

        def step(state, batch):
            p = state["params"]
            return {"params": p - 0.01 * (2 * p + batch)}, {
                "loss": jnp.sum(p ** 2)}

        def data(start):
            return (jnp.full((4,), float(s)) for s in range(start, 10_000))

        losses = _Losses()
        hooks = [JStopAtStepHook(T_TOTAL), type(
            "L", (JBaseHook,), {"after_step": losses.after_step})()]
        if sentinel:
            hooks.insert(0, JAnomalySentinelHook(budget=3))
        ckpt = JCheckpointer(tmpdir, max_to_keep=3)
        try:
            out = jrun_with_recovery(
                sched.wrap_step(step), {"params": jnp.ones((4,))},
                sched.inject_data(data, checkpoint_dir=tmpdir), ckpt,
                hooks=hooks, checkpoint_every=T_EVERY, max_restarts=8, **kw)
        finally:
            ckpt.close()
    finally:
        jevents.install(prev)
    return np.asarray(out["params"]), _trace(rec), losses.losses


def _port_run(tmpdir, make_faults, sentinel, **kw):
    rec = tevents.FlightRecorder()
    prev = tevents.install(rec)
    try:
        sched = FaultSchedule(make_faults())
        losses = _Losses()
        hooks = [StopAtStepHook(T_TOTAL), type(
            "L", (BaseHook,), {"after_step": losses.after_step})()]
        if sentinel:
            hooks.insert(0, AnomalySentinelHook(budget=3))
        ckpt = Checkpointer(tmpdir, max_to_keep=3)
        try:
            out = run_with_recovery(
                sched.wrap_step(_toy_step), _toy_init(),
                sched.inject_data(_toy_data, checkpoint_dir=tmpdir), ckpt,
                hooks=hooks, checkpoint_every=T_EVERY, max_restarts=8,
                device="cpu", **kw)
        finally:
            ckpt.close()
    finally:
        tevents.install(prev)
    return out["params"].numpy(), _trace(rec), losses.losses


TRACE_CASES = {
    "step_exception": (lambda k: [k.Fault("step_exception", 12)], False, {}),
    "nan_batch": (lambda k: [k.Fault("nan_batch", 12)], True, {}),
    "ckpt_truncate": (lambda k: [k.Fault("ckpt_truncate", 11),
                                 k.Fault("step_exception", 12)], False, {}),
    "ckpt_corrupt": (lambda k: [k.Fault("ckpt_corrupt", 11),
                                k.Fault("step_exception", 12)], False, {}),
    "iterator_stall": (lambda k: [k.Fault("iterator_stall", 12, param=1.0)],
                       False, {"data_deadline_s": 0.25}),
    "storm": (lambda k: k.FaultSchedule.random(
        3, max_position=T_TOTAL - 2, n_faults=4, min_position=2,
        stall_s=0.6).faults, True, {"data_deadline_s": 0.25}),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_recovery_trace_equals_the_references(tmp_path, case):
    make, sentinel, kw = TRACE_CASES[case]
    from distributed_tensorflow_guide_tpu_torch.testing import chaos

    jp, jtrace, jlosses = _jax_run(tmp_path / "jax", lambda: make(jchaos),
                                   sentinel, **kw)
    tp, ttrace, tlosses = _port_run(tmp_path / "port", lambda: make(chaos),
                                    sentinel, **kw)
    assert any(r[0] == "elastic.restart" for r in jtrace)
    assert ttrace == jtrace
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses]
    finite = [(a, b) for (_, a), (_, b) in zip(tlosses, jlosses)
              if np.isfinite(b)]
    np.testing.assert_allclose([a for a, _ in finite],
                               [b for _, b in finite], rtol=1e-5, atol=1e-5)


# ---- kill mid-save, across real processes ------------------------------------


def test_kill_mid_save_then_resume_bitwise(tmp_path):
    """Run 1 is SIGKILLed right after an async save(4) returned, while its
    writer may still be writing. Run 2 sweeps the debris, restores the
    newest valid checkpoint and finishes with the uninterrupted 8-step
    result."""
    d = str(tmp_path / "ck")
    runner = mp.MultiProcessRunner("tests.torch_mp_workers:kill_mid_save_job",
                                   1, args=(d, True), timeout=120).start()
    marker = pathlib.Path(d) / "saved_marker"
    deadline = time.time() + 90
    while time.time() < deadline and not marker.exists():
        time.sleep(0.02)
    assert marker.exists(), "run 1 never reached its save point"
    runner.kill(0)
    results = runner.join(raise_on_error=False)
    assert not results[0].ok

    r = mp.run_multiprocess("tests.torch_mp_workers:kill_mid_save_job", 1,
                            args=(d, False), timeout=120)[0].result
    assert r["resumed_from"] in (0, 4)
    assert r["w"] == 8.0
    # the uncommitted save's directory was swept at start-up
    assert r["cleaned"] == [] or r["cleaned"] == ["4.ckpt-tmp"]
