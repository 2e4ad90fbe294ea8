"""A run of each cell, past the look for a card, at a size the CPU holds:
sound, it comes out correct; with the timed path broken underneath, or
with the control (the reference in fp8) in the program's place, it does
not. The chip's readings at the cells' own sizes are ``control.py``'s."""

import numpy as np
import pytest
import torch

import tiny
from portbench import control, harness

TRAIN = ["resnet50_train_b256", "gpt2_train_b12s1024"]
SERVE = ["gpt2_serve_chat64", "gpt2_serve_rag64"]


def passed(out) -> dict:
    return {c["name"]: c["value"] <= c["limit"] for c in out["checks"]}


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(cell):
    out = tiny.run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell,
                                                           monkeypatch):
    from distributed_tensorflow_guide_tpu_torch.train import state

    monkeypatch.setattr(state.TrainState, "apply_gradients",
                        lambda self, grads: self)
    out = tiny.run(cell)
    assert not out["correct"]
    change = [k for k in passed(out) if k.startswith("change_gap")]
    assert change and not any(passed(out)[k] for k in change)


def _half_rows(make):
    def wrapped(model, *a, **kw):
        inner = make(model, *a, **kw)

        def loss_fn(module, batch):
            half = {k: v[: len(v) // 2] for k, v in batch.items()}
            return inner(module, half)

        return loss_fn

    return wrapped


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_caught(cell, monkeypatch):
    from distributed_tensorflow_guide_tpu_torch.models import (
        resnet,
        transformer,
    )

    monkeypatch.setattr(resnet, "make_loss_fn",
                        _half_rows(resnet.make_loss_fn))
    monkeypatch.setattr(transformer, "make_lm_loss_fn",
                        _half_rows(transformer.make_lm_loss_fn))
    out = tiny.run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_a_token_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    from distributed_tensorflow_guide_tpu_torch.serve import scheduler

    vocab = tiny.CONFIGS["gpt2-124m"]["vocab_size"]
    orig = scheduler.Scheduler.apply_decode

    def altered(self, slot_idx, token):
        return orig(self, slot_idx, (token + 1) % vocab)

    monkeypatch.setattr(scheduler.Scheduler, "apply_decode", altered)
    out = tiny.run(cell)
    assert not out["correct"], out["checks"]
    assert not passed(out)["logit_gap"]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_fp8_control_fails_a_training_number(cell):
    s = tiny.spec(cell)
    got = control.reading(s, 3, tiny.CPU, "fp8", tiny.seconds_for(cell))
    assert any(got[k] > s["limits"][k]
               for k in ("loss_gap", "grad_gap", "change_gap")), got


@pytest.mark.parametrize("cell", SERVE)
def test_the_fp8_control_fails_the_logit_gap(cell):
    s = tiny.spec(cell)
    got = control.reading(s, 3, tiny.CPU, "fp8", tiny.seconds_for(cell))
    assert got["logit_gap"] > s["limits"]["logit_gap"], got


def test_the_reference_sees_the_fault_where_planted():
    s = tiny.spec("gpt2_train_b12s1024")
    got = control.reading(s, 4, tiny.CPU, "half_batch", 1.0)
    assert got["grad_gap"] > s["limits"]["grad_gap"]
    assert np.isfinite(got["loss_gap"])
    torch.manual_seed(0)


def test_frozen_convolution_kernels_are_caught():
    # a fault confined to a third of the leaves, which the median leaf's
    # gaps cannot see: the loss of the later steps does
    s = tiny.spec("resnet50_train_b256")
    got = control.reading(s, 3, tiny.CPU, "conv_frozen", 1.0)
    assert got["change_gap"] == 1.0
    assert any(got[k] > v for k, v in s["limits"].items()), got


def test_the_loss_gap_reads_the_mix_steps_and_prints_the_rest():
    from portbench.reference import compare

    leaves = {"a": 1.0, "b": 2.0}
    ref = {"losses": [10.0, 10.0, 10.0], "grad_norms": leaves,
           "change_norms": leaves}
    prog = dict(ref, losses=[10.0, 10.001, 10.1])
    got = compare.train_gaps(prog, ref, loss_steps=2)
    assert got["loss_gap"] == pytest.approx(1e-4)
    assert got["loss_gap_all"] == pytest.approx(1e-2)
    assert compare.train_gaps(prog, ref)["loss_gap"] == pytest.approx(1e-2)


def test_a_skipped_replay_fails_the_loss_of_its_first_step():
    # a captured call whose replay never runs leaves its losses at 0;
    # the first replayed step is inside the compared losses
    from portbench.reference import compare

    mix = harness.cell_spec("gpt2_train_b12s1024")["mix"]
    k, n = int(mix["steps_per_call"]), int(mix["loss_steps"])
    assert k < n <= int(mix["ref_steps"])
    leaves = {"a": 1.0}
    ref = {"losses": [10.0] * int(mix["ref_steps"]), "grad_norms": leaves,
           "change_norms": leaves}
    prog = dict(ref, losses=[10.0] * k + [0.0] * (len(ref["losses"]) - k))
    assert compare.train_gaps(prog, ref, n)["loss_gap"] == 1.0


@pytest.mark.parametrize("cell", TRAIN)
def test_the_program_in_float32_matches_the_reference(cell):
    # the witness that the gaps of a sound run are bf16's rounding
    s = tiny.spec(cell)
    got = control.reading(s, 3, tiny.CPU, "f32", 1.0)
    assert all(got[k] < 1e-4 for k in ("loss_gap", "grad_gap",
                                       "change_gap")), got
