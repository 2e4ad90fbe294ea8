"""The port's synthetic data, MNIST CNN, Wide&Deep and held-out
evaluation, held to the JAX package on the same weights and batches.

Geometry: the MNIST CNN as published (28x28x1, Conv 32 and 64, Dense 128,
10 classes) at batch 8; Wide&Deep over vocabularies (50, 40, 30), 8 dense
features, embeddings of 8 and an MLP of (16, 8) at batch 16; float32.
Weights cross through ``bridge.mnist_cnn_from_flax`` /
``wide_deep_from_flax``; the JAX side runs under ``jax.jit``.

Tolerances, float32 throughout: synthetic batches bitwise equal; logits
and losses 1e-5 absolute and relative; gradients 5e-5 absolute and 1e-4
relative (the convolutions sum in other orders); the five-step SGD-
momentum curve 1e-5, and the parameters after it 1e-5 absolute and 1e-4
relative; the five-step Adam curve 1e-4 (Adam normalises each step, so
the gradients' rounding grows a little each step); the evaluation means
1e-6.
"""

import functools

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
from distributed_tensorflow_guide_tpu_torch.data import synthetic as tsyn
from distributed_tensorflow_guide_tpu_torch.models import mnist_cnn as tmnist
from distributed_tensorflow_guide_tpu_torch.models import wide_deep as twd
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.train import evaluation
from distributed_tensorflow_guide_tpu_torch.train.hooks import (
    BaseHook,
    StopAtStepHook,
)
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
VOCABS = (50, 40, 30)
WD_GEOM = dict(vocab_sizes=VOCABS, num_dense=8, embed_dim=8, mlp_dims=(16, 8))
LR_SGD, LR_ADAM = 0.05, 1e-2


def _np_tree(tree):
    return jax.tree.map(np.asarray, fnn.meta.unbox(tree))


def _assert_trees_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(leaf, np.asarray(flat[path]),
                                   err_msg=str(path), **tol)


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _curve(step, state, batches):
    """Losses of a TrainLoop over ``batches`` on the CPU."""
    seen = []

    class Record(BaseHook):
        def after_step(self, step, metrics):
            seen.append(metrics["loss"].item())

    TrainLoop(step, state, batches, hooks=[Record()], device="cpu").run()
    return seen


def _jax_curve(model, loss_fn, params, tx, batches):
    jdp = JDataParallel(single_device_mesh())
    jstep = jdp.make_train_step(loss_fn, donate=False)
    jstate = jdp.replicate(train_state.TrainState.create(
        apply_fn=model.apply, params=params, tx=tx))
    out = []
    for b in batches:
        jstate, m = jstep(jstate, jdp.shard_batch(b))
        out.append(float(m["loss"]))
    return out, jstate


# ---- synthetic data ----------------------------------------------------------

DATASETS = {
    "mnist": lambda mod, seed: mod.synthetic_mnist(8, seed=seed),
    "mnist_held_out": lambda mod, seed: mod.synthetic_mnist(
        8, seed=seed, sample_seed=seed + 100),
    "imagenet": lambda mod, seed: mod.synthetic_imagenet(4, image_size=32,
                                                         seed=seed),
    "ctr": lambda mod, seed: mod.SyntheticCTR(16, vocab_sizes=VOCABS,
                                              seed=seed),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(DATASETS))
def test_synthetic_batches_are_bitwise_the_jax_packages(name, seed):
    got = DATASETS[name](tsyn, seed).take(3)
    want = DATASETS[name](jsyn, seed).take(3)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert np.array_equal(g[k], w[k]), k


# ---- MNIST CNN -------------------------------------------------------------


@pytest.fixture(scope="module")
def mnist_params():
    return _np_tree(jmnist.MNISTCNN().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"])


def _mnist(params):
    m = tmnist.MNISTCNN()
    m.load_state_dict(bridge.mnist_cnn_from_flax(params))
    return m


def test_mnist_logits_loss_accuracy_and_gradients_match_jax(mnist_params):
    batch = tsyn.synthetic_mnist(8, seed=3).take(1)[0]
    jmodel = jmnist.MNISTCNN()
    want = jax.jit(jmodel.apply)({"params": mnist_params}, batch["image"])
    (j_loss, j_mets), j_grads = jax.jit(jax.value_and_grad(
        jmnist.make_loss_fn(jmodel), has_aux=True))(mnist_params, batch)
    model = _mnist(mnist_params)
    with torch.no_grad():
        got = model(torch.as_tensor(batch["image"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    (loss, mets), grads = value_and_grad(tmnist.make_loss_fn(model), model,
                                         _torch(batch))
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    assert mets["accuracy"].item() == float(j_mets["accuracy"])
    _assert_trees_close(bridge.mnist_cnn_to_flax(grads), j_grads,
                        **GRAD_TOL)


def test_mnist_flattens_in_nhwc_order(mnist_params):
    """Dense_0's rows are (h, w, c): a plain transpose in the bridge."""
    model = _mnist(mnist_params)
    kernel = np.array(mnist_params["Dense_0"]["kernel"])
    assert torch.equal(model.dense0.weight, torch.from_numpy(kernel.T))


def test_mnist_five_sgd_momentum_steps_match_jax(mnist_params):
    batches = tsyn.synthetic_mnist(8, seed=4).take(5)
    jmodel = jmnist.MNISTCNN()
    want, jstate = _jax_curve(jmodel, jmnist.make_loss_fn(jmodel),
                              mnist_params, optax.sgd(LR_SGD, momentum=0.9),
                              batches)
    model = _mnist(mnist_params)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR_SGD,
                                              momentum=0.9))
    step = DataParallel(device="cpu").make_train_step(
        tmnist.make_loss_fn(model))
    got = _curve(step, state, batches)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    _assert_trees_close(bridge.mnist_cnn_to_flax(model.state_dict()),
                        _np_tree(jstate.params), atol=1e-5, rtol=1e-4)


# ---- Wide&Deep ---------------------------------------------------------------


@pytest.fixture(scope="module")
def wd_params():
    return _np_tree(jwd.WideDeep(**WD_GEOM).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 3), jnp.int32),
        jnp.zeros((1, 8)))["params"])


def _wide_deep(params):
    m = twd.WideDeep(**WD_GEOM)
    m.load_state_dict(bridge.wide_deep_from_flax(params))
    return m


def test_wide_deep_logits_loss_and_embedding_gradients_match_jax(wd_params):
    batch = tsyn.SyntheticCTR(16, vocab_sizes=VOCABS, seed=2).take(1)[0]
    jmodel = jwd.WideDeep(**WD_GEOM)
    want = jax.jit(jmodel.apply)({"params": wd_params}, batch["cat"],
                                 batch["dense"])
    (j_loss, j_mets), j_grads = jax.jit(jax.value_and_grad(
        jwd.make_loss_fn(jmodel), has_aux=True))(wd_params, batch)
    model = _wide_deep(wd_params)
    with torch.no_grad():
        got = model(torch.as_tensor(batch["cat"]),
                    torch.as_tensor(batch["dense"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    (loss, mets), grads = value_and_grad(twd.make_loss_fn(model), model,
                                         _torch(batch))
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    assert mets["accuracy"].item() == float(j_mets["accuracy"])
    # dense embedding gradients: a row per id, zero where no id landed
    for i, v in enumerate(VOCABS):
        g = grads[f"emb.{i}.weight"]
        assert g.layout == torch.strided and g.shape == (v, 8)
        seen = np.zeros(v, bool)
        seen[batch["cat"][:, i]] = True
        assert torch.all(g[torch.from_numpy(~seen)] == 0)
    _assert_trees_close(bridge.wide_deep_to_flax(grads), j_grads,
                        **GRAD_TOL)


def test_wide_deep_five_adam_steps_match_jax(wd_params):
    batches = tsyn.SyntheticCTR(16, vocab_sizes=VOCABS, seed=5).take(5)
    jmodel = jwd.WideDeep(**WD_GEOM)
    want, _ = _jax_curve(jmodel, jwd.make_loss_fn(jmodel), wd_params,
                         optax.adam(LR_ADAM), batches)
    model = _wide_deep(wd_params)
    state = TrainState(model, torch.optim.Adam(model.parameters(),
                                               lr=LR_ADAM))
    step = DataParallel(device="cpu").make_train_step(
        twd.make_loss_fn(model))
    np.testing.assert_allclose(_curve(step, state, batches), want,
                               atol=1e-4)


@pytest.mark.parametrize("which", ["mnist", "wide_deep"])
def test_bridges_round_trip_exactly(which, mnist_params, wd_params):
    if which == "mnist":
        params, back = mnist_params, bridge.mnist_cnn_to_flax(
            _mnist(mnist_params).state_dict())
    else:
        params, back = wd_params, bridge.wide_deep_to_flax(
            _wide_deep(wd_params).state_dict())
    _assert_trees_close(back, params, atol=0, rtol=0)


def test_init_weights_are_seeded():
    a = tmnist.MNISTCNN().init_weights(1).state_dict()
    b = tmnist.MNISTCNN().init_weights(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = twd.WideDeep(**WD_GEOM).init_weights(2)
    assert torch.all(w.mlp[0].bias == 0)
    assert w.emb[0].weight.std().item() == pytest.approx(8 ** -0.5, rel=0.2)


# ---- held-out evaluation ---------------------------------------------------


def test_evaluator_means_match_the_jax_evaluator(mnist_params):
    held_out = tsyn.synthetic_mnist(8, seed=0, sample_seed=9).take(3)
    jmodel = jmnist.MNISTCNN()
    jdp = JDataParallel(single_device_mesh())
    jstate = jdp.replicate(train_state.TrainState.create(
        apply_fn=jmodel.apply, params=mnist_params, tx=optax.sgd(0.1)))
    want = jeval.Evaluator(
        jdp.make_eval_step(jmnist.make_metric_fn(jmodel)),
        lambda: [jdp.shard_batch(b) for b in held_out]).run(jstate)
    model = _mnist(mnist_params)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    got = evaluation.Evaluator(
        DataParallel(device="cpu").make_eval_step(
            tmnist.make_metric_fn(model)), lambda: held_out).run(state)
    assert got.keys() == want.keys() and got["eval_batches"] == 3.0
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6, rel=1e-6), k
    with pytest.raises(ValueError, match="no batches"):
        evaluation.Evaluator(lambda s, b: {}, lambda: []).run(state)


def test_eval_hook_runs_once_at_the_end(mnist_params):
    model = _mnist(mnist_params)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.01))
    dp = DataParallel(device="cpu")
    held_out = tsyn.synthetic_mnist(8, seed=0, sample_seed=9).take(2)
    calls = []

    def eval_step(st, batch):
        calls.append(st.step)
        return dp.make_eval_step(tmnist.make_metric_fn(model))(st, batch)

    hook = evaluation.EvalHook(evaluation.Evaluator(eval_step,
                                                    lambda: held_out))
    TrainLoop(dp.make_train_step(tmnist.make_loss_fn(model)), state,
              iter(functools.partial(next, iter(
                  tsyn.synthetic_mnist(8, seed=1))), None),
              hooks=[StopAtStepHook(5), hook], device="cpu").run()
    assert calls == [5, 5]
    assert hook.latest["eval_batches"] == 2.0
    assert 0.0 <= hook.latest["accuracy"] <= 1.0
