"""The port's supervised recovery, preemption and periodic evaluation
(``train/elastic.py``, ``train/evaluation.EvalHook``) held to the JAX
package's ``tests/test_elastic.py`` and ``tests/test_evaluation.py`` pins on
the CPU.

Crash / resume, the restart budget, a corrupt newest checkpoint and a
warm-started directory run the tiny LM of ``tests/torch_mp_workers.py``
(2 layers, d=64, Adam) and end bitwise equal to the uninterrupted run.
Preemption: SIGTERM is deferred to the step boundary, saved at the
completed-step count, acted on at ``sync_every`` agreement points, drained
at the end, and the original handler comes back on every exit path.
One 2-rank gloo job crashes abruptly after a checkpoint and a fresh job
resumes it (the reference's least-squares problem; its parameters equal
the uninterrupted single-process run's within 1e-4, as there).
"""

import logging
import os
import signal

import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
    corrupt_checkpoint,
)
from distributed_tensorflow_guide_tpu_torch.train import (
    BaseHook,
    Checkpointer,
    EvalHook,
    Evaluator,
    PreemptionHook,
    StopAtStepHook,
    TooManyRestarts,
    TrainLoop,
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


def _run(tmpdir, *, crash_at=None, total=TOTAL, max_restarts=3):
    crashed = []
    state = W.rl_state()
    base = W.rl_step(state)

    def step(state, batch):
        if crash_at is not None and not crashed and state.step == crash_at:
            crashed.append(True)
            raise RuntimeError("injected crash")
        return base(state, batch)

    ckpt = Checkpointer(tmpdir, max_to_keep=2)
    try:
        return run_with_recovery(
            step, state, W.rl_data, ckpt, hooks=[StopAtStepHook(total)],
            checkpoint_every=CKPT_EVERY, max_restarts=max_restarts,
            device="cpu")
    finally:
        ckpt.close()


@pytest.fixture(scope="module")
def clean():
    return W.rl_oracle(range(TOTAL))


@pytest.mark.parametrize("crash_at", [2, 9])
def test_crash_resume_matches_uninterrupted(tmp_path, clean, crash_at):
    """A crash before the first checkpoint starts fresh (the supervisor's
    host copy of the initial state, restored in place); a later one
    restores step 8. Both end bitwise the uninterrupted run."""
    assert W.rl_equal(clean, _run(tmp_path / "c", crash_at=crash_at))


def test_restart_budget_enforced(tmp_path):
    def always_fail(state, batch):
        raise RuntimeError("permanent failure")

    ckpt = Checkpointer(tmp_path / "fail", max_to_keep=1)
    try:
        with pytest.raises(TooManyRestarts):
            run_with_recovery(always_fail, W.rl_state(), W.rl_data, ckpt,
                              hooks=[StopAtStepHook(TOTAL)],
                              checkpoint_every=CKPT_EVERY, max_restarts=2,
                              device="cpu")
    finally:
        ckpt.close()


def test_corrupt_newest_checkpoint_does_not_crash_loop_recovery(tmp_path):
    d = tmp_path / "trunc"
    _run(d)  # saves 4 / 8 / 12; max_to_keep=2 keeps 8 and 12
    assert corrupt_checkpoint(d, mode="truncate")[0] == TOTAL
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("dtg.train").addHandler(handler)
    try:
        final = _run(d, total=16)
    finally:
        logging.getLogger("dtg.train").removeHandler(handler)
    assert any("restore ladder" in m and f"[{TOTAL}]" in m for m in records)
    assert W.rl_equal(W.rl_oracle(range(16)), final)


def test_resume_from_existing_checkpoint_dir(tmp_path):
    d = tmp_path / "extend"
    _run(d)
    assert W.rl_equal(W.rl_oracle(range(16)), _run(d, total=16))


def test_multiprocess_crash_and_resume(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    first = mp.MultiProcessRunner(
        "tests.torch_mp_workers:elastic_dp_job", 2,
        args=(ckpt_dir, W.MP_CRASH_AFTER), timeout=120).start().join(
            raise_on_error=False)
    assert all(not r.ok for r in first)
    assert any("CRASHING" in r.stdout for r in first)
    results = mp.run_multiprocess("tests.torch_mp_workers:elastic_dp_job",
                                  2, args=(ckpt_dir, -1), timeout=120)
    for r in results:
        assert r.result["resumed_from"] == W.MP_CKPT_EVERY
        assert r.result["steps_done"] == W.MP_TOTAL
    gx, gy = W.mp_elastic_problem()
    w = np.zeros(4, np.float32)
    for s in range(W.MP_TOTAL):
        f = 1.0 + s / 10.0
        x, y = gx * f, gy * f
        w = w - W.MP_LR * (2.0 / len(x)) * x.T @ (x @ w - y)
    for r in results:
        assert r.result["w"] == pytest.approx(w.tolist(), rel=1e-4)


# ---- preemption ----------------------------------------------------------------


def _toy_step(state, batch):
    p = state["params"]
    return {"params": p - 0.01 * (2 * p + batch["x"])}, {
        "loss": (p ** 2).sum()}


def _toy_init():
    return {"params": torch.ones(4)}


def _toy_data(start):
    return ({"x": np.full((4,), float(s), np.float32)}
            for s in range(start, 10_000))


def _sigterm_at(value):
    def step(state, batch):
        if float(batch["x"][0]) == value:
            os.kill(os.getpid(), signal.SIGTERM)  # the handler only flags
        return _toy_step(state, batch)

    return step


def _loop(step, state, hooks, start=0):
    return TrainLoop(step, state, _toy_data(start), hooks=hooks,
                     start_step=start, device="cpu")


def test_preemption_sigterm_saves_and_resumes(tmp_path):
    ref = _loop(_toy_step, _toy_init(), [StopAtStepHook(20)]).run()
    ckpt = Checkpointer(tmp_path / "pre")
    hook = PreemptionHook(ckpt)
    original = signal.getsignal(signal.SIGTERM)
    loop1 = _loop(_sigterm_at(3), _toy_init(), [StopAtStepHook(20), hook])
    mid = loop1.run()
    assert hook.preempted_at == 4 and ckpt.latest_step() == 4
    assert loop1.step == 4 and loop1.stop_reason == "preemption"
    assert signal.getsignal(signal.SIGTERM) == original
    start = ckpt.latest_step()
    final = _loop(_toy_step, ckpt.restore(mid), [StopAtStepHook(20)],
                  start).run()
    assert torch.equal(final["params"], ref["params"])
    ckpt.close()


def test_preemption_sync_every_cadence_and_final_drain(tmp_path):
    ckpt = Checkpointer(tmp_path / "late")
    hook = PreemptionHook(ckpt, sync_every=50)
    loop = _loop(_sigterm_at(3), _toy_init(), [StopAtStepHook(20), hook])
    loop.run()
    assert loop.step == 20  # no agreement point mid-run: no early stop
    assert hook.preempted_at == 20 and ckpt.latest_step() == 20
    assert loop.stop_reason == "preemption"  # the drain retags the stop
    ckpt.close()

    ckpt2 = Checkpointer(tmp_path / "aligned")
    hook2 = PreemptionHook(ckpt2, sync_every=4)
    loop2 = _loop(_sigterm_at(0), _toy_init(), [StopAtStepHook(20), hook2])
    loop2.run()
    assert hook2.preempted_at == 4 and loop2.step == 4
    ckpt2.close()


def test_preemption_handler_restored_after_crash(tmp_path):
    original = signal.getsignal(signal.SIGTERM)
    ckpt = Checkpointer(tmp_path / "crash")

    def bad_step(state, batch):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        _loop(bad_step, _toy_init(), [PreemptionHook(ckpt)]).run()
    assert signal.getsignal(signal.SIGTERM) == original
    ckpt.close()


def test_preemption_hook_reusable_across_runs(tmp_path):
    ckpt = Checkpointer(tmp_path / "reuse", max_to_keep=5)
    hook = PreemptionHook(ckpt)
    mid = _loop(_sigterm_at(2), _toy_init(),
                [StopAtStepHook(20), hook]).run()
    assert hook.preempted_at == 3
    start = ckpt.latest_step()
    _loop(_sigterm_at(6), ckpt.restore(mid), [StopAtStepHook(20), hook],
          start).run()
    assert hook.preempted_at == 7 and ckpt.latest_step() == 7
    ckpt.close()


def test_preemption_handler_restored_when_later_hook_begin_raises(tmp_path):
    class _BadBegin(BaseHook):
        def begin(self, loop):
            raise PermissionError("cannot open metrics file")

    original = signal.getsignal(signal.SIGTERM)
    ckpt = Checkpointer(tmp_path / "bb")
    with pytest.raises(PermissionError):
        _loop(_toy_step, _toy_init(), [PreemptionHook(ckpt),
                                       _BadBegin()]).run()
    assert signal.getsignal(signal.SIGTERM) == original
    ckpt.close()


# ---- EvalHook ------------------------------------------------------------------


def _evaluator(calls):
    def eval_step(state, batch):
        calls.append(1)
        return {"loss": (state["params"] ** 2).sum() + batch["x"].sum()}

    return Evaluator(eval_step, lambda: [{"x": torch.zeros(2)},
                                         {"x": torch.ones(2)}])


def test_eval_hook_every_n_and_at_the_end():
    calls = []
    hook = EvalHook(_evaluator(calls), every_steps=4)
    loop = _loop(_toy_step, _toy_init(), [StopAtStepHook(10), hook])
    loop.run()
    assert [s for s, _ in hook.history] == [4, 8, 10]
    assert hook.latest["eval_batches"] == 2.0 and len(calls) == 6
    # a final step that already evaluated is not evaluated again
    hook2 = EvalHook(_evaluator([]), every_steps=5)
    _loop(_toy_step, _toy_init(), [StopAtStepHook(10), hook2]).run()
    assert [s for s, _ in hook2.history] == [5, 10]
    with pytest.raises(ValueError, match="every_steps"):
        EvalHook(_evaluator([]), every_steps=-1)


def test_eval_hook_skips_the_end_pass_after_preemption(tmp_path):
    calls = []
    ckpt = Checkpointer(tmp_path / "ev")
    hook = EvalHook(_evaluator(calls))
    loop = _loop(_sigterm_at(2), _toy_init(),
                 [StopAtStepHook(20), PreemptionHook(ckpt), hook])
    loop.run()
    assert loop.stop_reason == "preemption" and ckpt.latest_step() == 3
    assert hook.history == [] and calls == []
    ckpt.close()
