"""The port's watchdog (``utils/watchdog.py``), anomaly sentinel
(``train/anomaly.py``), the loop's and the prefetcher's deadlines and the
sentinel's supervised rollback, held to the JAX package's
``tests/test_watchdog.py``, ``tests/test_anomaly.py`` and the loop half of
``tests/test_resilience.py`` on the CPU.

* The sentinel is the reference's host logic: fed the same metric stream
  (NaNs, spikes, a grad-norm blow-up, coarse check cadences, a save
  cadence), the port's hook trips at the same steps, with the same
  windows and reasons, as the JAX package's.
* Supervised rollback over a tiny LM (2 layers, d=64, Adam): a one-shot
  NaN batch, a persistent one with ``skip_offending`` at check cadences
  1 and 5, the budget. Final state bitwise the clean run's (or the run
  on the stream with the skipped window removed). The batch carries a
  float ``scale`` of 1.0 that multiplies the loss, so a poisoned batch
  NaNs the loss as the reference's float batches do.
* Watchdog deadlines stay at or below 0.5 s.
"""

import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.train import anomaly as janomaly
from distributed_tensorflow_guide_tpu_torch.core.dist import (
    retry_with_backoff,
)
from distributed_tensorflow_guide_tpu_torch.data.prefetch import (
    DevicePrefetchIterator,
)
from distributed_tensorflow_guide_tpu_torch.train import (
    AnomalyBudgetExceeded,
    AnomalyDetected,
    AnomalySentinelHook,
    BaseHook,
    Checkpointer,
    CheckpointHook,
    StopAtStepHook,
    TrainLoop,
    run_with_recovery,
)
from distributed_tensorflow_guide_tpu_torch.utils.watchdog import (
    DataStallError,
    TripInfo,
    Watchdog,
    WatchdogTimeout,
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


NAN = float("nan")

# ---- the watchdog (tests/test_watchdog.py) ---------------------------------


def test_no_trip_within_deadline():
    with Watchdog(poll_s=0.005) as wd:
        wd.arm("quick work", 0.5)
        time.sleep(0.02)
        wd.disarm()
        wd.check()
    assert wd.tripped is None


def test_trip_records_and_check_raises():
    trips = []
    with Watchdog(action=trips.append, poll_s=0.005) as wd:
        wd.arm("slow work", 0.03)
        time.sleep(0.15)
        with pytest.raises(WatchdogTimeout, match="slow work"):
            wd.check()
    assert len(trips) == 1 and isinstance(trips[0], TripInfo)
    assert trips[0].tag == "slow work" and trips[0].waited_s >= 0.03


def test_rearm_clears_previous_trip():
    with Watchdog(action=lambda info: None, poll_s=0.005) as wd:
        wd.arm("a", 0.02)
        time.sleep(0.1)
        assert wd.tripped is not None
        wd.arm("b", 0.5)  # a fresh guard must not inherit the stale trip
        wd.disarm()
        wd.check()


def test_diagnostics_dump_written(tmp_path):
    diag = tmp_path / "stacks.txt"
    with Watchdog(action=lambda info: None, diag_path=diag,
                  poll_s=0.005) as wd:
        wd.arm("stuck section", 0.02)
        time.sleep(0.1)
    text = diag.read_text()
    assert "stuck section" in text
    assert "Thread" in text or "File" in text


def test_interrupt_action_breaks_python_stall():
    with Watchdog(poll_s=0.005) as wd:
        wd.arm("stall", 0.05)
        with pytest.raises((KeyboardInterrupt, WatchdogTimeout)):
            try:
                for _ in range(1000):
                    time.sleep(0.01)
            except KeyboardInterrupt:
                wd.check()
                raise  # pragma: no cover - check always raises here
        wd.disarm()


def test_invalid_action_and_deadline_rejected():
    with pytest.raises(ValueError, match="action"):
        Watchdog(action="detonate")
    with Watchdog(poll_s=0.005) as wd:
        with pytest.raises(ValueError, match="deadline"):
            wd.arm("x", 0.0)


def _toy_step(state, batch):
    return state + batch["x"], {"loss": state}


def test_train_loop_data_deadline_converts_stall():
    def stalling_data():
        yield {"x": 1.0}
        while True:  # a Python-level stall, the watchdog's prey
            time.sleep(0.01)

    loop = TrainLoop(_toy_step, torch.zeros(()), stalling_data(),
                     data_deadline_s=0.2, device="cpu")
    with pytest.raises(WatchdogTimeout, match="data iterator"):
        loop.run()
    assert loop.step == 1


def test_train_loop_step_deadline_converts_slow_hook():
    class StuckHook(BaseHook):
        def after_step(self, step, metrics):
            if step == 2:
                while True:
                    time.sleep(0.01)

    loop = TrainLoop(_toy_step, torch.zeros(()), iter([{"x": 1.0}] * 100),
                     hooks=[StuckHook()], step_deadline_s=0.2, device="cpu")
    with pytest.raises(WatchdogTimeout, match="train step"):
        loop.run()


def test_train_loop_without_deadlines_has_no_watchdog():
    loop = TrainLoop(_toy_step, torch.zeros(()), iter([{"x": 1.0}] * 3),
                     device="cpu")
    assert float(loop.run()) == 3.0


def test_train_loop_deadline_not_tripped_by_fast_steps():
    loop = TrainLoop(_toy_step, torch.zeros(()), iter([{"x": 1.0}] * 20),
                     step_deadline_s=0.5, data_deadline_s=0.5, device="cpu")
    assert float(loop.run()) == 20.0 and loop.step == 20


def test_prefetch_max_host_wait_raises_data_stall():
    def slow_source():
        yield {"x": 1.0}
        time.sleep(0.3)
        yield {"x": 2.0}

    it = DevicePrefetchIterator(slow_source(), depth=1, put_fn=lambda b: b,
                                max_host_wait_s=0.05)
    # the eager refill fetches batch 2 inside the FIRST next(): fail-fast
    # preempts the buffered batch
    with pytest.raises(DataStallError, match="max_host_wait_s"):
        next(it)
    assert issubclass(DataStallError, RuntimeError)


def test_prefetch_stats_track_max_single_wait():
    def source():
        yield {"x": 1.0}
        time.sleep(0.1)
        yield {"x": 2.0}

    it = DevicePrefetchIterator(source(), depth=1, put_fn=lambda b: b)
    list(it)
    assert it.stats.max_host_wait_s >= 0.1
    assert "prefetch_max_host_wait_s" in it.stats.as_dict()


def test_prefetch_rejects_bad_deadline():
    with pytest.raises(ValueError, match="max_host_wait_s"):
        DevicePrefetchIterator(iter([]), max_host_wait_s=0.0, device="cpu")


def test_retry_with_backoff_retries_then_succeeds():
    calls, delays = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("coordinator not up yet")
        return "connected"

    out = retry_with_backoff(flaky, attempts=4, base_delay_s=1.0,
                             sleep=delays.append, what="handshake")
    assert out == "connected" and len(calls) == 3
    assert delays == [1.0, 2.0]


def test_retry_with_backoff_exhausts_and_reraises():
    delays = []
    with pytest.raises(RuntimeError, match="still down"):
        retry_with_backoff(
            lambda: (_ for _ in ()).throw(RuntimeError("still down")),
            attempts=3, base_delay_s=0.5, max_delay_s=0.75,
            sleep=delays.append)
    assert delays == [0.5, 0.75]


def test_retry_with_backoff_does_not_catch_foreign_errors():
    with pytest.raises(KeyError):
        retry_with_backoff(lambda: {}["missing"], attempts=5,
                           sleep=lambda s: None)


# ---- the sentinel's detection (tests/test_anomaly.py) ------------------------


def test_nan_loss_trips_immediately():
    hook = AnomalySentinelHook(budget=5)
    with pytest.raises(AnomalyDetected, match="not finite"):
        hook.after_step(0, {"loss": torch.tensor(NAN)})
    assert hook.trips and hook.trips[0][0] == 0


def test_nan_grad_norm_trips():
    hook = AnomalySentinelHook(budget=5)
    with pytest.raises(AnomalyDetected, match="grad_norm"):
        hook.after_step(0, {"loss": 1.0, "grad_norm": float("inf")})


def test_spike_needs_full_window_then_trips():
    hook = AnomalySentinelHook(spike_factor=10.0, window=5, budget=5)
    for s in range(5):
        hook.after_step(s, {"loss": torch.tensor(1.0)})
    hook.after_step(5, {"loss": 9.0})
    with pytest.raises(AnomalyDetected, match="spiked"):
        hook.after_step(6, {"loss": 100.0})


def test_warmup_spike_does_not_false_trip():
    hook = AnomalySentinelHook(spike_factor=2.0, window=10, budget=1)
    for s, loss in enumerate([100.0, 3.0, 55.0, 0.1]):
        hook.after_step(s, {"loss": loss})
    assert hook.trips == []


def test_check_every_skips_off_cadence_steps():
    hook = AnomalySentinelHook(check_every=4, budget=5)
    hook.after_step(1, {"loss": NAN})
    with pytest.raises(AnomalyDetected):
        hook.after_step(4, {"loss": NAN})


def test_grad_norm_spike_trips_on_its_own_history():
    hook = AnomalySentinelHook(spike_factor=10.0, window=4, budget=5)
    for s in range(4):
        hook.after_step(s, {"loss": 1.0, "grad_norm": 2.0})
    with pytest.raises(AnomalyDetected, match="grad_norm=200"):
        hook.after_step(4, {"loss": 1.0, "grad_norm": 200.0})


def test_detection_window_covers_unchecked_steps():
    hook = AnomalySentinelHook(check_every=5, budget=5)

    class _Loop:
        step = 0

    hook.begin(_Loop())
    hook.after_step(0, {"loss": 1.0})
    with pytest.raises(AnomalyDetected) as e:
        hook.after_step(5, {"loss": NAN})
    assert e.value.window_start == 1 and e.value.step == 5


def test_save_cadence_forces_check_before_save_boundary():
    hook = AnomalySentinelHook(check_every=50, budget=5)
    hook.save_cadence = 5
    hook.after_step(1, {"loss": NAN})
    with pytest.raises(AnomalyDetected):
        hook.after_step(4, {"loss": NAN})


def test_budget_exceeded_is_not_recoverable_type():
    hook = AnomalySentinelHook(budget=2)
    for step in (0, 1):
        with pytest.raises(AnomalyDetected):
            hook.after_step(step, {"loss": NAN})
    with pytest.raises(AnomalyBudgetExceeded):
        hook.after_step(2, {"loss": NAN})
    assert not isinstance(AnomalyBudgetExceeded("x"), RuntimeError)


def _stream(kind: str) -> list[dict]:
    rng = np.random.RandomState(11)
    base = [float(x) for x in 2.0 + 0.1 * rng.rand(40)]
    if kind == "nans":
        return [{"loss": NAN if s in (3, 17, 30) else v}
                for s, v in enumerate(base)]
    if kind == "spikes":
        return [{"loss": v * (40.0 if s in (25, 33) else 1.0)}
                for s, v in enumerate(base)]
    # a grad-norm blow-up while the loss looks sane, and one NaN loss
    return [{"loss": NAN if s == 36 else v,
             "grad_norm": 1.0 + v * (150.0 if s in (24, 31) else 1.0)}
            for s, v in enumerate(base)]


def _trips(cls, metrics, kw, begin_at):
    hook = cls(**kw)

    class _Loop:
        step = begin_at

    hook.begin(_Loop())
    if kw.get("check_every", 1) > 1:
        hook.save_cadence = 8
    out = []
    for s, m in enumerate(metrics):
        try:
            hook.after_step(s, m)
        except Exception as e:  # the trip, in either package's class
            out.append((type(e).__name__, s,
                        getattr(e, "window_start", None),
                        getattr(e, "reason", str(e))))
            if type(e).__name__ == "AnomalyBudgetExceeded":
                break
            hook.begin(_Loop())
    return out, hook.trips


@pytest.mark.parametrize("kind", ["nans", "spikes", "grad_norm"])
@pytest.mark.parametrize("check_every", [1, 3])
def test_sentinel_trips_where_the_reference_trips(kind, check_every):
    """The same metric stream through the JAX package's hook and the
    port's: the same trips (step, window start, reason), the same budget
    exhaustion. Metrics reach the port as 0-d tensors."""
    metrics = _stream(kind)
    kw = dict(spike_factor=10.0, window=8, budget=3,
              check_every=check_every, skip_offending=True)
    want, want_log = _trips(janomaly.AnomalySentinelHook, metrics, kw, 0)
    got, got_log = _trips(
        AnomalySentinelHook,
        [{k: torch.tensor(v) for k, v in m.items()} for m in metrics],
        kw, 0)
    assert want, "the stream must trip the reference"
    assert got == want
    assert got_log == want_log


# ---- supervised rollback over a tiny LM ---------------------------------------

TOTAL = 12
CKPT_EVERY = 4


def _data(poisoned=(), once=None):
    fired = set()

    def make(start):
        for p in range(start, 10_000):
            bad = p in poisoned or (p == once and p not in fired)
            if p == once:
                fired.add(p)
            yield W.rl_batch(p, bad)

    return make


def _supervised(tmp_path, make_data, hooks=(), **kw):
    state = W.rl_state()
    ckpt = Checkpointer(tmp_path, max_to_keep=3)
    try:
        return run_with_recovery(
            W.rl_step(state), state, make_data, ckpt,
            hooks=[StopAtStepHook(TOTAL), *hooks],
            checkpoint_every=CKPT_EVERY, device="cpu", **kw)
    finally:
        ckpt.close()


@pytest.fixture(scope="module")
def clean():
    return W.rl_oracle(range(TOTAL))


def test_transient_nan_rolls_back_to_bitwise_parity(tmp_path, clean):
    hook = AnomalySentinelHook(budget=3)
    out = _supervised(tmp_path / "nan", _data(once=6), hooks=[hook])
    assert [s for s, _ in hook.trips] == [6]
    assert W.rl_equal(clean, out)


def test_tripped_step_is_never_checkpointed(tmp_path):
    ckpt = Checkpointer(tmp_path / "b", max_to_keep=10)
    state = W.rl_state()
    try:
        run_with_recovery(
            W.rl_step(state), state, _data(once=CKPT_EVERY - 1), ckpt,
            hooks=[StopAtStepHook(TOTAL), AnomalySentinelHook(budget=3)],
            checkpoint_every=CKPT_EVERY, device="cpu")
        for s in ckpt.all_steps():
            restored = ckpt.restore(W.rl_state(), step=s)
            assert all(torch.isfinite(t).all()
                       for t in restored.model.state_dict().values()), s
    finally:
        ckpt.close()


def test_persistent_nan_without_skip_burns_budget(tmp_path):
    with pytest.raises(AnomalyBudgetExceeded):
        _supervised(tmp_path / "p", _data(poisoned={6}),
                    hooks=[AnomalySentinelHook(budget=2)], max_restarts=10)


@pytest.mark.parametrize("check_every,skipped", [(1, (6,)),
                                                 (5, (6, 7))])
def test_persistent_nan_with_skip_offending_converges(tmp_path, check_every,
                                                      skipped):
    """skip_offending drops the window that cannot be exonerated: the
    poisoned position alone at check_every=1; at 5 the last clean check is
    step 5 and the save-boundary check at step 7 (done = 8) trips with
    window [6..7]. The run equals the
    oracle on the stream without those positions, bitwise."""
    hook = AnomalySentinelHook(budget=3, skip_offending=True,
                               check_every=check_every)
    out = _supervised(tmp_path / "skip", _data(poisoned={6}), hooks=[hook])
    assert len(hook.trips) == 1
    positions = [p for p in range(40) if p not in skipped][:TOTAL]
    assert W.rl_equal(W.rl_oracle(positions), out)


def test_budget_exceeded_escapes_run_with_recovery(tmp_path):
    with pytest.raises(AnomalyBudgetExceeded):
        _supervised(tmp_path / "esc", _data(poisoned=set(range(10_000))),
                    hooks=[AnomalySentinelHook(budget=1)], max_restarts=50)


def test_sentinel_outside_recovery_plain_loop():
    data = iter([{"x": 1.0}, {"x": NAN}, {"x": 1.0}])

    def step(state, batch):
        return state, {"loss": batch["x"].sum()}

    loop = TrainLoop(step, {"w": torch.zeros(2)}, data,
                     hooks=[AnomalySentinelHook(budget=3)], device="cpu")
    with pytest.raises(AnomalyDetected):
        loop.run()
    assert loop.step == 1


# ---- CheckpointHook async mode (tests/test_resilience.py) --------------------


def _count_step(state, batch):
    return {"w": state["w"] + batch["x"]}, {"loss": state["w"].sum()}


def _run_hook_loop(tmpdir, async_save):
    ckpt = Checkpointer(tmpdir, max_to_keep=10)
    loop = TrainLoop(
        _count_step, {"w": torch.zeros((32,))},
        ({"x": np.full((32,), float(s), np.float32)} for s in range(1000)),
        hooks=[StopAtStepHook(9),
               CheckpointHook(ckpt, every_steps=2, async_save=async_save)],
        device="cpu")
    final = loop.run()
    ckpt.wait()
    steps = ckpt.all_steps()
    valid = [s for s in steps if ckpt.verify_step(s)]
    restored = ckpt.restore(final, step=max(steps))
    ckpt.close()
    return final, steps, valid, restored


def test_checkpoint_hook_async_parity_with_sync(tmp_path):
    f_sync, steps_sync, valid_sync, r_sync = _run_hook_loop(
        tmp_path / "sync", async_save=False)
    f_async, steps_async, valid_async, r_async = _run_hook_loop(
        tmp_path / "async", async_save=True)
    assert steps_sync == steps_async == valid_sync == valid_async
    assert torch.equal(r_sync["w"], r_async["w"])
    assert torch.equal(f_sync["w"], f_async["w"])
