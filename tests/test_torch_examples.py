"""The port's example family (``distributed_tensorflow_guide_tpu_torch/
examples/``), scripts 1-6, 13 and 14: each runs at the argv of the JAX
package's ``tests/test_examples.py`` (or its script's docstring), scaled
to 2-4 gloo ranks on the CPU, and prints its JAX twin's success lines;
the control trainer and Wide&Deep are held to the JAX package on weights
carried across by ``bridge.py``; the determinism gate takes the port's
control trainer as its oracle. Scripts 7-12 are in
``tests/test_torch_examples_lm.py``.

Tolerances, float32 throughout: the control trainer's five losses 1e-5
relative and its accuracies exact (the JAX gate's own tolerance is 1e-4);
Wide&Deep's five Adam losses 1e-4 relative (Adam normalises each step, so
the gradients' rounding grows a little each step, as in
``tests/test_torch_mnist_wide_deep.py``); the gate's topologies 1e-4
relative to the control, the JAX gate's ``rtol``; the evaluator's means
1e-6.
"""

import ast
import importlib
import re
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from distributed_tensorflow_guide_tpu.core.mesh import single_device_mesh
from distributed_tensorflow_guide_tpu.data import synthetic as jsyn
from distributed_tensorflow_guide_tpu.models import mnist_cnn as jmnist
from distributed_tensorflow_guide_tpu.models import wide_deep as jwd
from distributed_tensorflow_guide_tpu.parallel.data_parallel import (
    DataParallel as JDataParallel,
)
from distributed_tensorflow_guide_tpu.train import evaluation as jeval
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.data import importers
from distributed_tensorflow_guide_tpu_torch.examples import _common
from distributed_tensorflow_guide_tpu_torch.examples import (
    non_distributed,
    wide_deep_recommender,
)
from distributed_tensorflow_guide_tpu_torch.models import mnist_cnn as tmnist
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.train import evaluation
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from tests import torch_mp_workers as W

REPO = Path(__file__).resolve().parents[1]
PKG = "distributed_tensorflow_guide_tpu_torch.examples"
EXAMPLES = REPO / "distributed_tensorflow_guide_tpu_torch" / "examples"
# the 14 scripts, each with the least argv it parses
SCRIPTS = {
    "non_distributed": [], "mnist_sync_dp": [],
    "async_ps_family": ["--algo", "downpour"], "wide_deep_recommender": [],
    "native_data_pipeline": [], "resnet_imagenet_dp": [],
    "bert_tensor_parallel": [], "fsdp_zero3": [], "gpt2_pipeline": [],
    "long_context_sp": [], "gpt2_generate": [], "gpt2_serve": [],
    "moe_expert_parallel": [], "switch_moe_lm": [],
}


@pytest.fixture
def _one_thread():
    """Tiny ops: one intra-op thread keeps them from spinning against the
    other test workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(name: str, argv: list, capsys) -> tuple[dict, str]:
    """A script's ``main(argv)`` in this process (its ``--fake-devices``
    ranks are processes of their own): (rank 0's summary, its stdout)."""
    summary = importlib.import_module(f"{PKG}.{name}").main(argv)
    return summary, capsys.readouterr().out


def _subprocess(args: list, timeout: float = 300.0) -> str:
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=timeout, cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


# ---- the family as a whole --------------------------------------------------


def test_the_family_has_the_jax_examples_file_names():
    jax_names = {p.stem for p in (REPO / "examples").glob("*.py")}
    port_names = {p.stem for p in EXAMPLES.glob("*.py")
                  if not p.stem.startswith("_")}
    assert port_names == jax_names == set(SCRIPTS)


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_each_script_takes_its_jax_twins_flags(name):
    """Every flag of the JAX twin parses in the port's script (read from
    the twin's source: it is not imported); the port adds ``--device``
    (and ``--fake-devices`` where the twin had none), and ``gpt2_serve``
    its companion's ``--precision``."""
    twin = (REPO / "examples" / f"{name}.py").read_text()
    flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', twin))
    parser = importlib.import_module(f"{PKG}.{name}").parser()
    port = {o for a in parser._actions for o in a.option_strings}
    assert flags and flags <= port, sorted(flags - port)
    extra = port - flags - {"-h", "--help", "--device", "--fake-devices"}
    assert extra <= {"--no-causal", "--precision"}, sorted(extra)
    assert "--precision" not in extra or name == "gpt2_serve"


@pytest.mark.parametrize("name", sorted(SCRIPTS) + ["_common", "__init__"])
def test_no_script_imports_jax_or_the_jax_package(name):
    for mod in _imports(EXAMPLES / f"{name}.py"):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (name, mod)
        assert top != "distributed_tensorflow_guide_tpu", (name, mod)
        assert not mod.startswith("examples"), (name, mod)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_a_script_without_a_card_and_without_device_cpu_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    mod = importlib.import_module(f"{PKG}.{name}")
    args = mod.parser().parse_args(SCRIPTS[name])
    assert args.device == "cuda" and args.fake_devices == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(args)


def test_decode_impl_dense_is_refused_on_a_card_only():
    with pytest.raises(ValueError, match="no plain path"):
        _common.check_decode_impl("dense", torch.device("cuda"))
    for impl in ("auto", "pallas", "dense"):
        _common.check_decode_impl(impl, torch.device("cpu"))
    for impl in ("auto", "pallas"):
        _common.check_decode_impl(impl, torch.device("cuda"))


def test_data_share_is_the_jax_shard_batch_rows():
    b = {"x": np.arange(24).reshape(2, 6, 2), "y": np.arange(12).reshape(2, 6)}
    got = [_common.data_share(b, i, 3, dim=1) for i in range(3)]
    np.testing.assert_array_equal(
        np.concatenate([g["x"] for g in got], axis=1), b["x"])
    assert got[1]["y"].tolist() == [[2, 3], [8, 9]]
    with pytest.raises(SystemExit, match="does not divide"):
        _common.data_share(b, 0, 4, dim=1)


# ---- Evaluator(max_batches=), the JAX package's argument --------------------


@pytest.mark.parametrize("max_batches", [None, 1, 2, 5])
def test_evaluator_max_batches_matches_the_jax_evaluator(max_batches,
                                                         _one_thread):
    params = _mnist_params()
    held_out = jsyn.synthetic_mnist(8, seed=0, sample_seed=9).take(3)
    jmodel = jmnist.MNISTCNN()
    jdp = JDataParallel(single_device_mesh())
    jstate = jdp.replicate(train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.sgd(0.1)))
    want = jeval.Evaluator(
        jdp.make_eval_step(jmnist.make_metric_fn(jmodel)),
        lambda: [jdp.shard_batch(b) for b in held_out],
        max_batches=max_batches).run(jstate)
    model = tmnist.MNISTCNN()
    model.load_state_dict(bridge.mnist_cnn_from_flax(params))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    got = evaluation.Evaluator(
        DataParallel(device="cpu").make_eval_step(
            tmnist.make_metric_fn(model)), lambda: held_out,
        max_batches=max_batches).run(state)
    assert got["eval_batches"] == want["eval_batches"] == min(
        3, max_batches or 3)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6, rel=1e-6), k


# ---- 1. non_distributed: the control trainer --------------------------------


def _mnist_params(seed: int = 0):
    return jax.tree.map(np.asarray, fnn.meta.unbox(jmnist.MNISTCNN().init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))["params"]))


def test_non_distributed_runs_as_a_module():
    out = _subprocess(["-m", f"{PKG}.non_distributed", "--steps", "5",
                       "--global-batch", "32", "--log-every", "0",
                       "--device", "cpu"])
    assert "done: 5 steps" in out
    assert "platform: cpu" in out, out


def test_non_distributed_train_matches_the_jax_control(_one_thread):
    """(a) The port's ``train`` against the JAX package's
    ``examples/non_distributed.train`` on its own initial weights: every
    step's loss within 1e-5 relative, the accuracies equal."""
    sys.path.insert(0, str(REPO))
    from examples.non_distributed import train as jax_train

    want = jax_train(5, 32, 0.05, seed=0)
    model = tmnist.MNISTCNN()
    model.load_state_dict(bridge.mnist_cnn_from_flax(_mnist_params(0)))
    got = non_distributed.train(5, 32, 0.05, seed=0, device="cpu",
                                model=model)
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=1e-5)
    assert [m["accuracy"] for m in got] == pytest.approx(
        [m["accuracy"] for m in want], abs=1e-7)
    assert got[-1]["loss"] < got[0]["loss"]


def test_mnist_topology_determinism_gate_with_the_control_oracle():
    """The JAX package's gate (``tests/test_aux_subsystems.py``) on the
    port: the control trainer, then DP over 2 ranks, 2 with two
    accumulated microbatches, 1 (model axis 2) and FSDP over 2, each held
    to the control within 1e-4 relative by ``check_topologies``."""
    results = [r.result for r in mp.run_multiprocess(
        "tests.torch_mp_workers:examples_gate_job", 2, timeout=300)]
    for r in results:
        assert r["ok"], r["detail"]
        assert r["losses"] == results[0]["losses"]
    losses = results[0]["losses"]
    assert list(losses) == [repr(t) for t in W.EXAMPLES_TOPOLOGIES]
    control = losses["'control'"]
    assert len(control) == W.TOPO_STEPS and control[-1] < control[0]


# ---- 2. mnist_sync_dp -------------------------------------------------------


def _idx_mnist(root: Path) -> None:
    """A tiny MNIST in the IDX files' layout: 64 training and 32 test
    images drawn from the synthetic task, as uint8 pixels."""
    for split, n, seed in (("train", 64, 1), ("t10k", 32, 2)):
        b = jsyn.synthetic_mnist(n, seed=0, sample_seed=seed).take(1)[0]
        pixels = np.clip(b["image"][..., 0] * 64 + 128, 0, 255)
        importers.write_idx(root / f"{split}-images-idx3-ubyte",
                            pixels.astype(np.uint8))
        importers.write_idx(root / f"{split}-labels-idx1-ubyte",
                            b["label"].astype(np.uint8))


def test_mnist_sync_dp_idx_data_checkpoint_and_resume(tmp_path, capsys):
    _idx_mnist(tmp_path)
    ckpt = tmp_path / "ckpt"
    summary, out = _cli("mnist_sync_dp", [
        "--fake-devices", "2", "--steps", "4", "--global-batch", "16",
        "--eval-batches", "2", "--log-every", "0", "--data", str(tmp_path),
        "--ckpt-dir", str(ckpt)], capsys)
    assert "native loader: 64 records" in out, out
    assert "NativeRecordLoader" in out
    assert "done: 4 steps on 2 device(s)" in out
    assert "held-out accuracy" in out
    assert summary["world"] == 2 and len(summary["losses"]) == 4
    assert summary["launches"] == {}  # no kernel on the CPU
    # one process resumes the 2-rank run's checkpoint
    summary, out = _cli("mnist_sync_dp", [
        "--device", "cpu", "--steps", "6", "--global-batch", "16",
        "--eval-batches", "2", "--log-every", "0", "--data", str(tmp_path),
        "--ckpt-dir", str(ckpt)], capsys)
    assert "resumed from step 4" in out, out
    assert "done: 6 steps on 1 device(s)" in out
    assert len(summary["losses"]) == 2


def test_mnist_sync_dp_under_the_launcher_as_a_file():
    out = _subprocess([
        "-m", "distributed_tensorflow_guide_tpu_torch.launch", "-n", "2",
        "--device", "cpu", str(EXAMPLES / "mnist_sync_dp.py"), "--steps",
        "3", "--global-batch", "16", "--eval-batches", "1", "--log-every",
        "0", "--device", "cpu"])
    assert "[p0] done: 3 steps on 2 device(s)" in out, out
    assert "[p1] done: 3 steps on 2 device(s)" in out
    assert "launch: exit codes [0, 0]" in out


# ---- 3. async_ps_family -----------------------------------------------------


@pytest.mark.parametrize("algo,ranks", [
    ("hogwild", 4), ("downpour", 2), ("adag", 1), ("emulate-hogwild", 1),
    ("emulate-downpour", 1), ("emulate-adag", 1)])
def test_async_ps_family(algo, ranks, capsys, _one_thread):
    where = (["--fake-devices", str(ranks)] if ranks > 1
             else ["--device", "cpu"])
    summary, out = _cli("async_ps_family", [
        "--algo", algo, "--steps", "8", "--global-batch", "32", *where],
        capsys)
    if algo.startswith("emulate-"):
        mode = algo.removeprefix("emulate-")
        assert f"{mode} emulation: loss" in out
        assert "PS pushes by 4 workers" in out
        # Hogwild pushes at every event; the others once a worker's 4
        # events (the default --sync-period), in the seeded interleaving
        if mode == "hogwild":
            assert summary["pushes"] == 8
        else:
            assert summary["pushes"] <= 8 // 4
    else:
        assert f"done: algo={algo} on {ranks} device(s)" in out, out
    if algo == "hogwild":
        assert f"averaged over {ranks} diverged replicas" in out
    assert all(np.isfinite(summary["losses"]))


# ---- 4. wide_deep_recommender -----------------------------------------------


def test_wide_deep_recommender(capsys):
    summary, out = _cli("wide_deep_recommender", [
        "--fake-devices", "2", "--steps", "4", "--global-batch", "64",
        "--log-every", "2"], capsys)
    assert "done: 4 steps, 7.0M params (embeddings resident in HBM, no " \
           "PS)" in out, out
    assert summary["world"] == 2 and len(summary["losses"]) == 4


def test_wide_deep_first_losses_match_the_jax_example():
    """(b) The JAX example's model, optimizer and stream (published
    widths, Adam 1e-2, ``SyntheticCTR`` seed 0) against the port's script
    on the same initial weights: five losses within 1e-4 relative."""
    vocabs, B, steps = wide_deep_recommender.VOCABS, 64, 5
    jmodel = jwd.WideDeep(vocab_sizes=vocabs, num_dense=8, embed_dim=32,
                          mlp_dims=(256, 128))
    data = jsyn.SyntheticCTR(B, vocab_sizes=vocabs, num_dense=8)
    b0 = data.take(1)[0]
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(b0["cat"]),
                         jnp.asarray(b0["dense"]))["params"]
    # numpy before the JAX step donates the device arrays
    start = jax.tree.map(np.asarray, fnn.meta.unbox(params))
    jdp = JDataParallel(single_device_mesh())
    jstate = jdp.replicate(train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.adam(1e-2)))
    jstep = jdp.make_train_step(jwd.make_loss_fn(jmodel))
    want = []
    for b in jsyn.SyntheticCTR(B, vocab_sizes=vocabs,
                               num_dense=8).take(steps):
        jstate, m = jstep(jstate, jdp.shard_batch(b))
        want.append(float(m["loss"]))
    model = wide_deep_recommender.build_model("cpu")
    model.load_state_dict(bridge.wide_deep_from_flax(start))
    args = wide_deep_recommender.parser().parse_args([
        "--steps", str(steps), "--global-batch", str(B), "--log-every", "0",
        "--device", "cpu"])
    got = wide_deep_recommender.run(args, model=model)["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---- 5. native_data_pipeline ------------------------------------------------


def test_native_data_pipeline(capsys):
    summary, out = _cli("native_data_pipeline", [
        "--fake-devices", "2", "--steps", "7", "--global-batch", "32",
        "--records", "256", "--steps-per-call", "2"], capsys)
    # each rank reads its half of the 256 records, 16 rows a batch
    assert "loader: NativeRecordLoader, 256 records, 8 batches/epoch" in out, \
        out
    assert "examples/sec/process end-to-end" in out
    # 3 packed calls of 2 steps, then one step through the sibling
    assert len(summary["losses"]) == 4
    assert summary["prefetch"]["prefetch_batches"] == 3


# ---- 6. resnet_imagenet_dp --------------------------------------------------


def test_resnet_imagenet_dp(capsys):
    summary, out = _cli("resnet_imagenet_dp", [
        "--fake-devices", "2", "--steps", "6", "--model", "small",
        "--image-size", "32", "--global-batch", "16", "--num-classes", "10",
        "--eval-batches", "2", "--log-every", "0", "--overlap", "on"],
        capsys)
    assert "done: 6 steps (small, 32px) on 2 device(s); overlap=on" in out
    assert "held-out accuracy" in out, out
    assert summary["eval"]["eval_batches"] == 2.0


# ---- 13-14. the MoE pair ----------------------------------------------------


def test_moe_expert_parallel(capsys):
    summary, out = _cli("moe_expert_parallel", [
        "--fake-devices", "4", "--steps", "12"], capsys)
    assert ("experts sharded 4-way over 4 devices; tokens moved via "
            "all_to_all, parameters never moved") in out, out
    assert summary["losses"][-1] < summary["losses"][0]


def test_switch_moe_lm(capsys):
    summary, out = _cli("switch_moe_lm", [
        "--fake-devices", "4", "--expert", "2", "--steps", "10"], capsys)
    assert "switch-moe ok: 8 experts over expert=2 x data=2" in out, out
    assert summary["losses"][-1] < summary["losses"][0]
