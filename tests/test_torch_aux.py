"""The port's run configuration (``core/config.py``), determinism checker
(``utils/determinism.py``) and profiler (``utils/profiling.py``), held to
the JAX package's, and the config, determinism and profiler cases of the
JAX package's ``tests/test_aux_subsystems.py`` as the port's cases.

Tolerances: configs, JSON files and flight-recorder event signatures are
compared exactly. The determinism gate runs the MNIST CNN over four DP
topologies and FSDP in one 4-rank gloo job and holds them to each other
at the JAX gate's 1e-4 relative (the data axis sums the gradients in
another order at each size), and two runs of one topology bitwise.
"""

import dataclasses
import glob
import json

import pytest
import torch

from distributed_tensorflow_guide_tpu.core import config as jconfig
from distributed_tensorflow_guide_tpu.core import mesh as jmesh
from distributed_tensorflow_guide_tpu.obs import events as jevents
from distributed_tensorflow_guide_tpu.utils import determinism as jdet
from distributed_tensorflow_guide_tpu.utils import profiling as jprof
from distributed_tensorflow_guide_tpu_torch.core.config import RunConfig
from distributed_tensorflow_guide_tpu_torch.core.mesh import MeshSpec
from distributed_tensorflow_guide_tpu_torch.obs import events
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.utils import profiling
from distributed_tensorflow_guide_tpu_torch.utils.determinism import (
    check_runs,
    check_topologies,
)
from distributed_tensorflow_guide_tpu_torch.utils.profiling import (
    DispatchRecorder,
    ProfilerHook,
)
from tests import torch_mp_workers as W


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- config --------------------------------------------------------------------


def test_config_roundtrip_json(tmp_path):
    cfg = RunConfig(mesh=MeshSpec(data=2, model=4), steps=7, lr=0.5,
                    ckpt_dir=str(tmp_path / "ck"))
    p = tmp_path / "run.json"
    cfg.save(p)
    assert RunConfig.load(p) == cfg


def test_config_from_argv_defaults_and_overrides():
    cfg = RunConfig.from_argv([])
    assert cfg == RunConfig()
    cfg = RunConfig.from_argv(
        ["--steps", "42", "--lr", "0.01", "--mesh-model", "2",
         "--mesh-data", "-1", "--tb-logdir", "/tmp/tb"])
    assert cfg.steps == 42 and cfg.lr == 0.01
    assert cfg.mesh == MeshSpec(data=-1, model=2)
    assert cfg.tb_logdir == "/tmp/tb"
    assert cfg.ckpt_dir is None


def test_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown"):
        RunConfig.from_dict({"stepz": 1})


def test_config_field_coverage():
    names = {f.name for f in dataclasses.fields(RunConfig)} - {"mesh"}
    parser = RunConfig.parser()
    dests = {a.dest for a in parser._actions}
    assert names <= dests


ARGVS = [[], ["--steps", "20", "--global-batch", "8", "--seed", "3",
              "--profile-dir", "/tmp/p", "--mesh-data", "2",
              "--mesh-expert", "2", "--lr", "0.25", "--fake-devices", "4"],
         ["--ckpt-dir", "None", "--xla-overlap", "1", "--mesh-pipe", "4",
          "--mesh-data", "-1", "--log-every", "0"]]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "cpu", "overlap"])
def test_config_json_crosses_between_the_packages(argv, tmp_path):
    """The same argv gives equal ``to_dict`` (and the same JSON bytes) in
    both packages, and a config saved by either loads in the other,
    equal."""
    mine = RunConfig.from_argv(argv)
    theirs = jconfig.RunConfig.from_argv(argv)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.to_json() == theirs.to_json()
    mine.save(tmp_path / "port.json")
    theirs.save(tmp_path / "jax.json")
    assert RunConfig.load(tmp_path / "jax.json") == mine
    assert jconfig.RunConfig.load(tmp_path / "port.json") == theirs
    assert ([f.name for f in dataclasses.fields(MeshSpec)]
            == [f.name for f in dataclasses.fields(jmesh.MeshSpec)])


def test_apply_platform_selects_the_cpu_and_refuses_xla_flags():
    assert RunConfig().apply_platform() is None
    assert RunConfig(fake_devices=4).apply_platform() == "cpu"
    with pytest.raises(ValueError, match="no PyTorch meaning"):
        RunConfig(xla_overlap=1).apply_platform()


# -- determinism checker -----------------------------------------------------


def _toy_train(seed: int):
    w = torch.randn(4, generator=torch.Generator().manual_seed(seed))
    return [{"loss": float(torch.sum(w ** 2) * (step + 1))}
            for step in range(3)]


def test_check_runs_passes_for_deterministic_fn():
    rep = check_runs(_toy_train, seed=3, runs=3)
    assert rep.ok and rep.max_abs_diff == 0.0


def test_check_runs_catches_nondeterminism():
    state = {"n": 0}

    def flaky(seed):
        state["n"] += 1
        return [{"loss": 1.0 + 0.1 * state["n"]}]

    rep = check_runs(flaky, runs=2)
    assert not rep.ok
    with pytest.raises(AssertionError):
        rep.raise_if_failed()


def test_check_runs_fails_on_one_sided_nan():
    state = {"n": 0}

    def diverges_once(seed):
        state["n"] += 1
        return [{"loss": float("nan") if state["n"] == 2 else 1.0}]

    rep = check_runs(diverges_once, runs=2)
    assert not rep.ok and "NaN" in rep.detail


def test_check_topologies_tolerance():
    def train(spec: MeshSpec, seed: int):
        eps = 1e-7 if spec.model > 1 else 0.0
        return [{"loss": 1.0 + eps}]

    rep = check_topologies(
        train, [MeshSpec(data=-1), MeshSpec(data=-1, model=2)], rtol=1e-5)
    assert rep.ok
    rep = check_topologies(
        train, [MeshSpec(data=-1), MeshSpec(data=-1, model=2)], rtol=1e-9)
    assert not rep.ok


@pytest.mark.parametrize("ms", [
    [[{"loss": 1.0}], [{"loss": 1.0}]],
    [[{"loss": 1.0, "acc": 0.5}], [{"loss": 1.0 + 1e-6, "acc": 0.5}]],
    [[{"loss": 1.0}], [{"loss": 1.0}, {"loss": 2.0}]],
    [[{"loss": 1.0}], [{"acc": 1.0}]],
    [[{"loss": float("nan")}], [{"loss": 1.0}]],
], ids=["equal", "drift", "length", "keys", "nan"])
def test_reports_equal_the_jax_packages(ms):
    """The same metric sequences give the same report (ok, both diffs,
    the detail text) in both packages; tensors read as their floats."""
    seqs = iter(ms * 2)
    mine = check_runs(lambda s: next(seqs), rtol=1e-7)
    theirs = jdet.check_runs(lambda s: next(seqs), rtol=1e-7)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    as_tensors = [[{k: torch.tensor(v) for k, v in m.items()} for m in run]
                  for run in ms]
    seqs = iter(as_tensors)
    assert check_runs(lambda s: next(seqs), rtol=1e-7).ok == mine.ok


# -- profiler ------------------------------------------------------------------


def _traces(path) -> list:
    return glob.glob(str(path / "**" / "*.pt.trace.json"), recursive=True)


def test_profiler_hook_writes_trace(tmp_path):
    hook = ProfilerHook(tmp_path, start_step=2, end_step=4, device="cpu")
    for s in range(6):
        torch.ones(8).sum()
        hook.after_step(s, {})
    hook.end(6)
    assert not hook._active
    assert _traces(tmp_path), "no Chrome trace written"


def test_profiler_hook_start_step_zero(tmp_path):
    hook = ProfilerHook(tmp_path, start_step=0, end_step=2, device="cpu")

    class FakeLoop:
        step = 0

    hook.begin(FakeLoop())
    assert hook._active
    for s in range(3):
        torch.ones(8).sum()
        hook.after_step(s, {})
    assert not hook._active
    assert _traces(tmp_path)


def test_profiler_hook_stops_on_early_end(tmp_path):
    hook = ProfilerHook(tmp_path, start_step=1, end_step=100, device="cpu")
    hook.after_step(0, {})
    assert hook._active
    hook.end(1)
    assert not hook._active
    assert len(_traces(tmp_path)) == 1


def _hook_events(mod, hook_cls, logdir, script, **kw):
    rec = mod.FlightRecorder(capacity=64)
    hook = hook_cls(logdir, start_step=2, end_step=5, recorder=rec, **kw)

    class Loop:
        step = 0

    for op, *a in script:
        if op == "begin":
            Loop.step = a[0]
            hook.begin(Loop())
        elif op == "after":
            hook.after_step(a[0], {})
        else:
            hook.end(a[0])
    return rec.events()


SCRIPTS = {
    "window": [("begin", 0), *[("after", s) for s in range(7)], ("end", 7)],
    "starts_at_first_step": [("begin", 3), ("after", 3), ("after", 4),
                             ("end", 5)],
    "early_end": [("begin", 0), ("after", 0), ("after", 1), ("after", 2),
                  ("end", 3)],
    "restart_mid_window": [("begin", 0), ("after", 0), ("after", 1),
                           ("after", 2), ("begin", 3), ("after", 3),
                           ("after", 4), ("end", 5)],
    "resume_past_window": [("begin", 9), ("after", 9), ("end", 10)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_profiler_hook_events_equal_the_jax_hooks(script, tmp_path,
                                                 monkeypatch):
    """The same begin / after_step / end sequence gives the same
    ``profiler.start`` / ``profiler.stop`` events (kind, category, actor,
    step, logdir) from both hooks. The JAX hook's XPlane tracer is stubbed:
    only its window logic is compared."""
    monkeypatch.setattr(jprof.jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jprof.jax.profiler, "stop_trace", lambda: None)
    logdir = str(tmp_path)
    mine = _hook_events(events, ProfilerHook, logdir, SCRIPTS[script],
                        device="cpu")
    theirs = _hook_events(jevents, jprof.ProfilerHook, logdir,
                          SCRIPTS[script])
    assert events.signature(mine) == jevents.signature(theirs)
    assert {e.kind for e in mine} <= {"profiler.start", "profiler.stop"}


def test_trace_names_annotations_and_step_spans(tmp_path):
    with profiling.trace(tmp_path, device="cpu"):
        for s in range(2):
            with profiling.step_annotation(s):
                with profiling.annotate("data_load", shard=0):
                    torch.ones(8).sum()
    (path,) = _traces(tmp_path)
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    assert names.count("train") == 2 and names.count("data_load") == 2


def test_save_memory_profile_raises_on_the_cpu(tmp_path):
    with pytest.raises(NotImplementedError, match="CPU"):
        profiling.save_memory_profile(tmp_path / "m.pickle", device="cpu")
    assert not (tmp_path / "m.pickle").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_the_profiler_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProfilerHook(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.save_memory_profile(tmp_path / "m.pickle")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(tmp_path):
            pass
    assert profiling.activities("cpu") == [
        torch.profiler.ProfilerActivity.CPU]


def test_dispatch_recorder_counts_calls_and_steps():
    rec = DispatchRecorder(lambda st, b: (st + 1, {}), steps_per_call=4)
    st = 0
    for _ in range(3):
        st, _ = rec(st, None)
    assert st == 3
    d = rec.stats.as_dict()
    assert d["dispatches"] == 3 and d["opt_steps"] == 12
    assert set(d) == set(jprof.DispatchStats(dispatches=1).as_dict())


# -- the determinism gate -------------------------------------------------------


def test_mnist_topology_determinism_gate():
    """The JAX package's gate in the port: the MNIST CNN trained by the
    same seed over a data axis of 4, 2 (also with two accumulated
    microbatches) and 1 rank of a 4-rank gloo job, and by FSDP over 4,
    gives matching metrics (``check_topologies`` at 1e-4; the data axis of
    1 is the single-process control), and one topology run twice gives
    the same bits."""
    results = [r.result for r in mp.run_multiprocess(
        "tests.torch_mp_workers:topology_job", 4, timeout=300)]
    for r in results:
        assert r["ok"], r["detail"]
        assert r["runs_ok"] and r["runs_max_abs_diff"] == 0.0
        assert r["losses"] == results[0]["losses"]
    losses = results[0]["losses"]
    assert len(losses) == len(W.TOPOLOGIES)
    curve = next(iter(losses.values()))
    assert len(curve) == W.TOPO_STEPS and curve[-1] < curve[0]
