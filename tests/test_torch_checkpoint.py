"""The port's checkpointer (``train/checkpoint.py``) held to the pins of the
JAX package's ``tests/test_checkpoint.py`` and the checkpoint half of
``tests/test_resilience.py``, on the CPU.

The reference saves through Orbax and the port through ``torch.save``, so
nothing is computed on both sides: each test holds the port to the
reference test's own pin (round trip bitwise, completed-step labels, the
manifest's sizes and CRCs, the ladder over truncation and a same-size
flip, startup hygiene, the layout pin, the async commit barrier). On top:

* an async save copies the state to host before it returns: an in-place
  Adam step run right after ``save(async_=True)`` returns changes nothing
  that was saved;
* a restore writes into the state's own tensors (``data_ptr`` unchanged),
  the contract a captured ``MultiStep`` needs (CPU graphs do not exist,
  so the address identity stands in for the replay; the card test
  ``test_torch_kernels_gpu.py`` replays one), and the restored step
  continues bitwise;
* one 2-rank gloo job (``tests/torch_mp_workers.py:ckpt_fsdp_job``): FSDP
  shards saved by every rank, replicated DP state by rank 0, each
  restored in place and continued bitwise; a sharded checkpoint refuses
  another world size.
"""

import json
import logging

import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.core import graphs
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    MeshSpec,
    build_mesh,
)
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.pipeline import (
    PipelinedLM,
)
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
    corrupt_checkpoint,
)
from distributed_tensorflow_guide_tpu_torch.train import (
    Checkpointer,
    CheckpointHook,
    LayoutMismatchError,
    StateMismatchError,
    StopAtStepHook,
    TrainLoop,
    TrainState,
    WorldSizeMismatchError,
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


CFG = ttf.TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                            d_model=64, d_ff=128, max_len=16, causal=True,
                            dtype=torch.float32)


def _lm_state(seed=0):
    model = ttf.Transformer(CFG).init_weights(seed)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))


def _lm_step(state):
    return DataParallel(device="cpu").make_train_step(
        ttf.make_lm_loss_fn(state.model, fused_ce=False))


def _tokens(s, rows=2):
    return {"tokens": torch.as_tensor(np.random.RandomState(s).randint(
        0, 64, (rows, 16)), dtype=torch.int64)}


def _tensors(state):
    """Every tensor of a TrainState, in a fixed order: parameters, then
    the optimizer's state."""
    return ([t for t in state.model.state_dict().values()]
            + [v for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v)])


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    assert a.step == b.step


def _toy(scale=1.0):
    return {"params": torch.full((64,), float(scale)),
            "opt": torch.zeros((64,))}


def _inc(state, batch):
    return {"w": state["w"] + 1.0}, {}


# ---- round trip, labels, resume (tests/test_checkpoint.py) ------------------


def test_save_restore_roundtrip_bitwise(tmp_path):
    state = _lm_state(0)
    step = _lm_step(state)
    for s in range(2):
        state, _ = step(state, _tokens(s))
    ckpt = Checkpointer(tmp_path / "ckpt")
    ckpt.save(2, state)
    ckpt.wait()
    assert ckpt.latest_step() == 2
    fresh = _lm_state(1)
    _lm_step(fresh)(fresh, _tokens(9))  # live Adam state to write into
    restored = ckpt.restore(fresh)
    assert restored is fresh
    _assert_same(state, restored)
    # as saved: the packed dicts, on the CPU
    raw = ckpt.restore(None)
    assert raw["step"] == 2 and set(raw["model"]["state"]) == set(
        state.model.state_dict())
    ckpt.close()


def test_restore_missing_raises(tmp_path):
    ckpt = Checkpointer(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_lm_state())
    ckpt.close()


def test_checkpoint_hook_saves_periodically_and_at_end(tmp_path):
    ckpt = Checkpointer(tmp_path / "ckpt", max_to_keep=10)

    def step_fn(state, batch):
        state.step += 1
        return state, {"loss": torch.zeros(())}

    loop = TrainLoop(step_fn, _lm_state(), iter(lambda: {"x": 0.0}, 1),
                     hooks=[StopAtStepHook(5),
                            CheckpointHook(ckpt, every_steps=2)],
                     device="cpu")
    final = loop.run()
    ckpt.wait()
    assert ckpt.latest_step() == 5  # the end-of-run save
    # labels are completed-step counts and equal the state's own step
    for label in (2, 4, 5):
        assert ckpt.restore(final, step=label).step == label
    ckpt.close()


def test_resumed_finished_run_is_a_noop():
    state = {"w": torch.zeros(())}
    loop = TrainLoop(_inc, state, iter(lambda: {"x": 0.0}, 1),
                     hooks=[StopAtStepHook(3)], start_step=3, device="cpu")
    final = loop.run()
    assert loop.step == 3 and float(final["w"]) == 0.0


def test_resume_continues_from_checkpoint(tmp_path):
    ckpt = Checkpointer(tmp_path / "ckpt")
    loop = TrainLoop(_inc, {"w": torch.zeros(())},
                     iter(lambda: {"x": 0.0}, 1),
                     hooks=[StopAtStepHook(3)], device="cpu")
    final = loop.run()
    ckpt.save(int(final["w"]), final)
    ckpt.wait()
    start = ckpt.latest_step()
    resumed = ckpt.restore({"w": torch.zeros(())})
    loop2 = TrainLoop(_inc, resumed, iter(lambda: {"x": 0.0}, 1),
                      hooks=[StopAtStepHook(6)], start_step=start,
                      device="cpu")
    final2 = loop2.run()
    assert loop2.step == 6 and float(final2["w"]) == 6.0
    ckpt.close()


def test_default_layout_pins_hook_driven_saves(tmp_path):
    layout_a = {"schedule": "interleaved", "P": 2, "v": 2}
    ckpt = Checkpointer(tmp_path / "ckpt", default_layout=layout_a)
    loop = TrainLoop(_inc, {"w": torch.zeros(())},
                     iter(lambda: {"x": 0.0}, 1),
                     hooks=[StopAtStepHook(2),
                            CheckpointHook(ckpt, every_steps=2)],
                     device="cpu")
    final = loop.run()
    ckpt.wait()
    assert (tmp_path / "ckpt" / "layout_2.json").exists()
    assert float(ckpt.restore(final)["w"]) == 2.0
    ckpt.close()
    other = Checkpointer(tmp_path / "ckpt",
                         default_layout={"schedule": "gpipe", "P": 4, "v": 1})
    with pytest.raises(ValueError, match="layout mismatch"):
        other.restore(final)
    # an explicit layout=None opts out (foreign-topology inspection)
    assert float(other.restore(final, layout=None)["w"]) == 2.0
    other.close()


def test_layout_sidecar_refuses_another_pipeline_layout(tmp_path):
    """``PipelinedLM.layout_metadata()`` as the pin: a stage saved from
    an interleaved (v=2) pipeline restores into its own layout bitwise and
    raises ``LayoutMismatchError`` against a v=1 pipeline's layout before
    any tensor is read (the port's stages name their chunks, so the trees
    would differ too; the pin is what says why)."""
    cfg = ttf.TransformerConfig(vocab_size=64, num_layers=8, num_heads=2,
                                d_model=16, d_ff=32, max_len=8, causal=True,
                                dtype=torch.float32)
    mesh = build_mesh(MeshSpec(data=1, pipe=1))
    pp2 = PipelinedLM(mesh, cfg, num_microbatches=2, virtual_chunks=2,
                      device="cpu")
    pp1 = PipelinedLM(mesh, cfg, num_microbatches=2, device="cpu")
    module = pp2.init_params(0)
    ck = Checkpointer(tmp_path / "ck")
    ck.save(1, module, layout=pp2.layout_metadata())
    fresh = pp2.init_params(1)
    restored = ck.restore(fresh, layout=pp2.layout_metadata())
    for a, b in zip(module.state_dict().values(),
                    restored.state_dict().values()):
        assert torch.equal(a, b)
    assert pp1.layout_metadata() != pp2.layout_metadata()
    with pytest.raises(LayoutMismatchError, match="layout mismatch"):
        ck.restore(pp1.init_params(0), layout=pp1.layout_metadata())
    ck.close()


# ---- async save + commit barrier (tests/test_resilience.py) -----------------


def test_async_save_defers_manifest_to_barrier(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d)
    assert ckpt.save(1, _toy(), async_=True)
    assert not (d / "manifest_1.json").exists()
    ckpt.wait()
    assert (d / "manifest_1.json").exists()
    assert ckpt.verify_step(1)
    restored = ckpt.restore(_toy(0.0))
    assert torch.equal(restored["params"], _toy()["params"])
    ckpt.close()


def test_async_save_commits_at_next_save(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d, max_to_keep=5)
    ckpt.save(1, _toy(1), async_=True)
    ckpt.save(2, _toy(2), async_=True)  # the barrier for step 1 runs first
    assert (d / "manifest_1.json").exists()
    ckpt.close()  # close is a barrier too: commits step 2
    assert (d / "manifest_2.json").exists()


def test_sync_save_commits_immediately(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d)
    ckpt.save(3, _toy())
    man = json.loads((d / "manifest_3.json").read_text())
    assert man["step"] == 3 and man["files"]
    assert all(len(v) == 2 for v in man["files"].values())
    assert set(man["files"]) == {"meta.json", "state.pt"}
    ckpt.close()


def test_latest_step_is_a_barrier(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(4, _toy(), async_=True)
    assert ckpt.latest_step() == 4
    assert (tmp_path / "ck" / "manifest_4.json").exists()
    ckpt.close()


def test_async_restore_roundtrip_bitwise_after_mutation(tmp_path):
    """The host copy happens at save() time: mutating the live state after
    save returns, before the barrier, leaks nothing into the checkpoint
    (a tensor and a numpy array alike)."""
    ckpt = Checkpointer(tmp_path / "ck")
    state = {"w": torch.arange(1024, dtype=torch.float32),
             "n": np.arange(16, dtype=np.int32)}
    ckpt.save(1, state, async_=True)
    state["w"] += 777.0
    state["n"] += 5
    restored = ckpt.restore({"w": torch.zeros(1024),
                             "n": np.zeros(16, np.int32)})
    assert torch.equal(restored["w"], torch.arange(1024,
                                                   dtype=torch.float32))
    assert isinstance(restored["n"], np.ndarray)
    np.testing.assert_array_equal(restored["n"], np.arange(16))
    ckpt.close()


def test_in_place_step_after_async_save_changes_nothing_saved(tmp_path):
    """``TrainState.apply_gradients`` writes parameters and Adam moments
    in place: a step run right after ``save(async_=True)`` returns must
    not reach what was saved, and the restore equals the state at save
    time bitwise."""
    state = _lm_state(0)
    step = _lm_step(state)
    state, _ = step(state, _tokens(0))
    at_save = [t.clone() for t in _tensors(state)]
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, state, async_=True)
    state, _ = step(state, _tokens(1))  # in place, while the writer runs
    assert not all(torch.equal(a, b) for a, b in zip(at_save,
                                                     _tensors(state)))
    ckpt.wait()
    restored = ckpt.restore(_lm_state(3))
    for a, b in zip(at_save, _tensors(restored)):
        assert torch.equal(a, b)
    assert restored.step == 1
    ckpt.close()


def test_restore_in_place_keeps_addresses_and_continues_bitwise(tmp_path):
    """A captured step replays fixed addresses: the restore must write
    into the state's own parameters and Adam tensors, and the
    k-step ``MultiStep`` must continue from it bitwise against an
    uninterrupted twin."""
    k = 2
    stream = [_tokens(s) for s in range(6)]
    packed = [{"tokens": torch.stack([stream[2 * i]["tokens"],
                                      stream[2 * i + 1]["tokens"]])}
              for i in range(3)]

    def build(seed):
        # capturable Adam needs the card; the CPU step is the eager twin
        state = _lm_state(seed)
        ms = DataParallel(device="cpu").make_train_step(
            ttf.make_lm_loss_fn(state.model, fused_ce=False),
            steps_per_call=k, stacked_batch=True, per_step_metrics=True)
        assert isinstance(ms, graphs.MultiStep)
        return state, ms

    ref, ref_step = build(0)
    for b in packed:
        ref, _ = ref_step(ref, b)

    run, run_step = build(0)
    run, _ = run_step(run, packed[0])
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(run.step, run)
    run, _ = run_step(run, packed[1])  # work the restore throws away
    ptrs = [t.data_ptr() for t in _tensors(run)]
    restored, at = ckpt.restore_latest_valid(run)
    assert at == k and restored is run and run.step == k
    assert [t.data_ptr() for t in _tensors(run)] == ptrs
    for b in packed[1:]:
        run, _ = run_step(run, b)
    _assert_same(ref, run)
    ckpt.close()


def test_fresh_optimizer_state_restores_in_place_as_zeros(tmp_path):
    """A checkpoint of a state whose optimizer has not stepped yet (a
    fresh start) zeroes the live Adam state in place: the next step is
    bitwise the first step of a fresh optimizer."""
    fresh = _lm_state(0)
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(0, fresh)
    ref = _lm_state(0)
    ref, _ = _lm_step(ref)(ref, _tokens(5))

    live = _lm_state(0)
    step = _lm_step(live)
    live, _ = step(live, _tokens(1))
    ptrs = [t.data_ptr() for t in _tensors(live)]
    ckpt.restore(live)
    assert [t.data_ptr() for t in _tensors(live)] == ptrs
    live, _ = step(live, _tokens(5))
    _assert_same(ref, live)
    ckpt.close()


def _misfit(state, fault):
    """Make ``state``'s optimizer disagree with a fresh one's in its last
    parameter, the leaf a restore reaches after every other."""
    last = list(state.model.parameters())[-1]
    st = state.optimizer.state[last]
    if fault == "moment_shape":
        st["exp_avg"] = torch.zeros(3)
    elif fault == "moment_dtype":
        st["exp_avg_sq"] = st["exp_avg_sq"].double()
    else:  # "optimizer_layout": the parameter has no state
        del state.optimizer.state[last]


@pytest.mark.parametrize("fault", ["moment_shape", "moment_dtype",
                                   "optimizer_layout"])
def test_misfit_checkpoint_is_refused_before_any_write(tmp_path, fault):
    """A checkpoint that does not fit the live state raises
    ``StateMismatchError`` before a tensor is written, from ``restore``
    and from the ladder alike (a configuration error, not corruption):
    the live parameters and moments stay bitwise as they were, though the
    misfit is in the last leaf and every parameter before it fits."""
    saved = _lm_state(1)
    _lm_step(saved)(saved, _tokens(3))
    _misfit(saved, fault)
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, saved)
    live = _lm_state(0)
    _lm_step(live)(live, _tokens(4))
    before = [t.clone() for t in _tensors(live)]
    with pytest.raises(StateMismatchError, match="state"):
        ckpt.restore(live)
    with pytest.raises(StateMismatchError):
        ckpt.restore_latest_valid(live)
    after = _tensors(live)
    assert len(after) == len(before) and live.step == 1
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    ckpt.close()


def test_optimizer_without_state_takes_the_checkpoint(tmp_path):
    """A live optimizer that has not stepped (a new process resuming) has
    no tensors a captured step could hold: it takes the saved state
    through ``load_state_dict`` and continues bitwise."""
    ref = _lm_state(0)
    step = _lm_step(ref)
    ref, _ = step(ref, _tokens(0))
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(ref.step, ref)
    live = _lm_state(1)
    assert not live.optimizer.state
    restored, at = ckpt.restore_latest_valid(live)
    assert restored is live and at == 1
    ref, _ = step(ref, _tokens(1))
    live, _ = _lm_step(live)(live, _tokens(1))
    _assert_same(ref, live)
    ckpt.close()


# ---- integrity manifest, ladder, hygiene (tests/test_resilience.py) ---------


def test_verify_step_catches_truncation(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, _toy())
    assert ckpt.verify_step(1)
    corrupt_checkpoint(tmp_path / "ck", mode="truncate")
    assert not ckpt.verify_step(1)
    ckpt.close()


def test_verify_step_catches_same_size_bitflip(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, _toy())
    step, rel = corrupt_checkpoint(tmp_path / "ck", mode="flip")
    manifest = json.loads((tmp_path / "ck" / "manifest_1.json").read_text())
    assert (tmp_path / "ck" / "1" / rel).stat().st_size == \
        manifest["files"][rel][0]
    assert not ckpt.verify_step(1)
    ckpt.close()


def test_manifest_gcd_with_max_to_keep(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d, max_to_keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _toy(s))
    assert ckpt.all_steps() == [3, 4]
    assert sorted(p.name for p in d.glob("manifest_*.json")) == [
        "manifest_3.json", "manifest_4.json"]
    ckpt.close()


def test_restore_ladder_falls_back_and_logs_skipped(tmp_path, caplog):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d, max_to_keep=4)
    ckpt.save(5, _toy(5))
    ckpt.save(10, _toy(10))
    corrupt_checkpoint(d, step=10, mode="truncate")
    with caplog.at_level(logging.WARNING, logger="dtg.train"):
        state, step = ckpt.restore_latest_valid(_toy(0))
    assert step == 5
    assert torch.equal(state["params"], _toy(5)["params"])
    assert any("restore ladder" in r.getMessage() and "[10]" in r.getMessage()
               for r in caplog.records)
    ckpt.close()


def test_restore_ladder_all_corrupt_returns_none(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d)
    ckpt.save(5, _toy(5))
    corrupt_checkpoint(d, step=5, mode="flip")
    assert ckpt.restore_latest_valid(_toy(0)) is None
    ckpt.close()


def test_restore_ladder_catches_unmanifested_corruption(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d, max_to_keep=4)
    ckpt.save(5, _toy(5))
    ckpt.save(10, _toy(10))
    (d / "manifest_10.json").unlink()  # a save from an older writer
    corrupt_checkpoint(d, step=10, mode="truncate")
    assert ckpt.verify_step(10)  # unverifiable: passes verification...
    state, step = ckpt.restore_latest_valid(_toy(0))  # ...restore catches
    assert step == 5
    ckpt.close()


def test_restore_ladder_reraises_layout_mismatch(tmp_path):
    d = tmp_path / "ck"
    ckpt = Checkpointer(d, default_layout={"schedule": "gpipe", "P": 2})
    ckpt.save(1, _toy())
    ckpt.close()
    other = Checkpointer(d, default_layout={"schedule": "1f1b", "P": 4})
    with pytest.raises(LayoutMismatchError):
        other.restore_latest_valid(_toy(0))
    other.close()


def test_restore_latest_valid_empty_dir_returns_none(tmp_path):
    ckpt = Checkpointer(tmp_path / "empty")
    assert ckpt.restore_latest_valid(_toy(0)) is None
    ckpt.close()


def test_init_cleans_stale_tmp_dirs(tmp_path):
    """A kill mid-save leaves ``<step>.ckpt-tmp`` (its rename never
    happened) and maybe a half-written manifest tmp; a fresh Checkpointer
    sweeps both and keeps the committed step."""
    d = tmp_path / "ck"
    ckpt = Checkpointer(d)
    ckpt.save(1, _toy())
    ckpt.close()
    tmp_dir = d / "7.ckpt-tmp"
    tmp_dir.mkdir()
    (tmp_dir / "state.pt").write_bytes(b"\0" * 512)
    (d / "manifest_7.json.tmp").write_text("{\"step\": 7")
    ckpt2 = Checkpointer(d)
    assert not tmp_dir.exists()
    assert not (d / "manifest_7.json.tmp").exists()
    assert sorted(ckpt2.cleaned_on_start) == ["7.ckpt-tmp",
                                              "manifest_7.json.tmp"]
    assert ckpt2.latest_step() == 1 and ckpt2.verify_step(1)
    ckpt2.close()


def test_clean_start_reports_nothing(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    assert ckpt.cleaned_on_start == []
    ckpt.close()


def test_restore_places_tensors_on_the_states_device(tmp_path):
    """Restore follows ``state_like``: a plain tree's tensors come back on
    its tensors' device and dtype, never on the device they were saved
    from (on the CPU both are the CPU; the card test saves from
    ``cuda:0``)."""
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, {"w": torch.arange(4, dtype=torch.float32),
                  "g": torch.Generator().manual_seed(7)})
    gen = torch.Generator().manual_seed(0)
    out = ckpt.restore({"w": torch.zeros(4, device="cpu"), "g": gen})
    assert out["w"].device.type == "cpu" and out["g"] is gen
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(7)))
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore({"w": torch.zeros(4)})
    ckpt.close()


# ---- several ranks -------------------------------------------------------------


def test_fsdp_shards_and_replicated_state_two_ranks(tmp_path):
    d = tmp_path / "mp"
    res = mp.run_multiprocess("tests.torch_mp_workers:ckpt_fsdp_job", 2,
                              args=(str(d),), timeout=240)
    for r in res:
        out = r.result
        for tag in ("fsdp", "dp"):
            assert out[f"{tag}/restored_step"] == W.CK_STEPS
            assert out[f"{tag}/same_object"] and out[f"{tag}/in_place"]
            assert out[f"{tag}/params_equal"], (r.rank, tag)
            assert out[f"{tag}/moments_equal"], (r.rank, tag)
            assert out[f"{tag}/continued_equal"], (r.rank, tag)
        assert out["fsdp/files"] == ["meta.json", "state_rank0.pt",
                                     "state_rank1.pt"]
        assert out["dp/files"] == ["meta.json", "state.pt"]
    # rank 0's manifest lists every rank's file
    man = json.loads((d / "fsdp" / f"manifest_{W.CK_STEPS}.json")
                     .read_text())
    assert {"state_rank0.pt", "state_rank1.pt"} <= set(man["files"])
    # another world size is refused, not resharded
    ckpt = Checkpointer(d / "fsdp", sharded=True)
    with pytest.raises(WorldSizeMismatchError, match="world size"):
        ckpt.restore_latest_valid(None)
    ckpt.close()
