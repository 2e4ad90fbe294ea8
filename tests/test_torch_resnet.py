"""The port's ResNet (BatchNorm, FusedBatchNormAct, the bottleneck, remat,
the loss with weight decay, the data-parallel step with running
statistics, the FLOP count), held to the JAX package on the same weights
and batches.

Geometry: stage sizes (1, 1), 8 filters, 10 classes, batch 8, float32; two
stems: ``small_inputs`` at 16x16 (3x3 stem) and the 7x7 stride-2 stem
with its ``SAME`` max-pool at 32x32, so that the stem, the max-pool's
(0, 1) padding and a stride-2 bottleneck's (0, 1) padding all run; each
with plain and fused BatchNorm. The odd cases (15x15, 30x30) pin the
(1, 1) padding of odd sizes. Every BatchNorm scale, bias and running
statistic is drawn at random from a seed (the initial scale of 0 would
silence the residual branches' gradients). Weights cross through
``bridge.resnet_from_flax`` / ``resnet_to_flax``; images are numpy. The
JAX side runs under ``jax.jit``, as its data-parallel step does: op by op,
its f32 gradients here differ from a float64 computation by more than the
gradient tolerance below; jitted, they agree with it as the port's do.

Tolerances, float32 throughout (oneDNN and XLA sum the convolutions in
other orders): logits and losses 2e-5 absolute and 1e-5 relative;
gradients 5e-5 absolute and 1e-4 relative; BatchNorm statistics 1e-6
absolute and relative; parameters after two SGD-momentum steps 1e-6.
``remat`` against no remat: equal within 1e-7 relative (the same ops run
again).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_guide_tpu.core.mesh import single_device_mesh
from distributed_tensorflow_guide_tpu.models import resnet as jres
from distributed_tensorflow_guide_tpu.parallel.data_parallel import (
    DataParallel as JDataParallel,
)
from distributed_tensorflow_guide_tpu.train.state import TrainStateWithStats
from distributed_tensorflow_guide_tpu.utils import flop_accounting as jflops
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import resnet as tres
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from distributed_tensorflow_guide_tpu_torch.utils import flop_accounting

VARIANTS = {"small": dict(small_inputs=True, size=16),
            "stem": dict(small_inputs=False, size=32)}
ODD = {"small": 15, "stem": 30}
GEOM = dict(stage_sizes=(1, 1), num_classes=10, num_filters=8)
OUT_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
STAT_TOL = dict(atol=1e-6, rtol=1e-6)
LR, WD = 0.05, 1e-3
CASES = [(v, f) for v in VARIANTS for f in (False, True)]
IDS = [f"{v}-{'fused' if f else 'plain'}" for v, f in CASES]


def _jmodel(variant, fused=False, **kw):
    return jres.ResNet(**GEOM, dtype=jnp.float32, fused_bn=fused,
                       small_inputs=VARIANTS[variant]["small_inputs"], **kw)


@functools.cache
def _variables(variant):
    """The JAX model's variables with random BatchNorm parameters and
    running statistics (numpy leaves)."""
    size = VARIANTS[variant]["size"]
    v = _jmodel(variant).init(jax.random.PRNGKey(0),
                              jnp.zeros((1, size, size, 3)), train=False)
    v = jax.tree.map(np.asarray, fnn.meta.unbox(v))
    rng = np.random.RandomState(7)

    def draw(path, x):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.3 * rng.randn(*x.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.2 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, v)


def _model(variant, fused=False, **kw):
    v = _variables(variant)
    m = tres.ResNet(**GEOM, dtype=torch.float32, fused_bn=fused,
                    small_inputs=VARIANTS[variant]["small_inputs"], **kw)
    m.load_state_dict(bridge.resnet_from_flax(v["params"],
                                              v["batch_stats"]))
    return m


def _batch(size, seed=0, n=8):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, size, size, 3).astype(np.float32),
            "label": rng.randint(0, 10, n).astype(np.int32)}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _assert_trees_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(leaf, np.asarray(flat[path]),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("size", [7, 8, 15, 16, 28, 29, 56, 57, 112, 113])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                      (7, 2)])
def test_same_padding_is_flax_rule(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert tres.same_pads(size, k, stride) == tuple(want[0])


@pytest.mark.parametrize("variant,fused", CASES, ids=IDS)
def test_train_logits_and_batch_statistics_match_jax(variant, fused):
    batch = _batch(VARIANTS[variant]["size"])
    v = _variables(variant)
    want, new_state = jax.jit(functools.partial(
        _jmodel(variant, fused).apply, train=True,
        mutable=["batch_stats"]))(v, batch["image"])
    model = _model(variant, fused).train()
    with torch.no_grad():
        got = model(torch.as_tensor(batch["image"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    _, stats = bridge.resnet_to_flax(model.state_dict())
    _assert_trees_close(stats, new_state["batch_stats"], **STAT_TOL)


@pytest.mark.parametrize("variant,fused", CASES, ids=IDS)
def test_eval_logits_use_the_running_statistics_as_jax(variant, fused):
    batch = _batch(VARIANTS[variant]["size"], seed=1)
    want = jax.jit(functools.partial(_jmodel(variant, fused).apply,
                                     train=False))(_variables(variant),
                                                   batch["image"])
    model = _model(variant, fused).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(torch.as_tensor(batch["image"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    for k, t in model.state_dict().items():  # nothing written
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("wd", [0.0, WD], ids=["no_wd", "wd"])
@pytest.mark.parametrize("variant,fused", CASES, ids=IDS)
def test_loss_and_every_gradient_match_jax(variant, fused, wd):
    batch = _batch(VARIANTS[variant]["size"], seed=2)
    v = _variables(variant)
    (j_loss, (j_mets, _)), j_grads = jax.jit(jax.value_and_grad(
        jres.make_loss_fn(_jmodel(variant, fused), wd), has_aux=True))(
        v["params"], {"batch_stats": v["batch_stats"]}, batch)
    model = _model(variant, fused).train()
    (loss, mets), grads = value_and_grad(
        tres.make_loss_fn(model, wd), model, _torch(batch))
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    assert mets["accuracy"].item() == float(j_mets["accuracy"])
    params, _ = bridge.resnet_to_flax(grads)
    _assert_trees_close(params, j_grads, **GRAD_TOL)


def test_weight_decay_covers_kernels_only():
    """0.5 * wd * the squares of the conv and head kernels, no BatchNorm
    parameter and no bias."""
    batch = _torch(_batch(16, seed=3))
    model = _model("small").train()
    base, _ = tres.make_loss_fn(model)(model, batch)
    model = _model("small").train()  # the same statistics again
    decayed, _ = tres.make_loss_fn(model, WD)(model, batch)
    kernels = [p for n, p in model.named_parameters()
               if n.endswith("weight") and p.ndim > 1]
    assert len(kernels) == 1 + 4 * 2 + 1  # stem, 4 per block, head
    want = 0.5 * WD * sum(float((p.double() ** 2).sum()) for p in kernels)
    np.testing.assert_allclose(decayed.item() - base.item(), want,
                               rtol=1e-4)


@pytest.mark.parametrize("variant", list(ODD))
def test_odd_sizes_pad_as_jax(variant):
    """At odd sizes flax's SAME pads (1, 1) where even sizes pad (0, 1):
    the small stem's stride-2 block at 15, the max-pool at 15 (30 after
    the 7x7 stem)."""
    size = ODD[variant]
    batch = _batch(size, seed=4)
    v = _variables(variant)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        jres.make_loss_fn(_jmodel(variant)), has_aux=True))(
        v["params"], {"batch_stats": v["batch_stats"]}, batch)
    model = _model(variant).train()
    (loss, _), grads = value_and_grad(tres.make_loss_fn(model), model,
                                      _torch(batch))
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    _assert_trees_close(bridge.resnet_to_flax(grads)[0], j_grads,
                        **GRAD_TOL)


@pytest.mark.parametrize("variant,fused", CASES, ids=IDS)
def test_two_sgd_momentum_steps_with_stats_match_jax(variant, fused):
    """``make_train_step_with_stats`` against the JAX step over
    ``optax.sgd(lr, momentum=0.9)``: parameters, running statistics and
    losses after two steps (the second uses the momentum)."""
    size = VARIANTS[variant]["size"]
    batches = [_batch(size, seed=10 + i) for i in range(2)]
    v = _variables(variant)
    jmodel = _jmodel(variant, fused)
    jdp = JDataParallel(single_device_mesh())
    jstep = jdp.make_train_step_with_stats(jres.make_loss_fn(jmodel, WD),
                                           donate=False)
    jstate = jdp.replicate(TrainStateWithStats.create(
        apply_fn=jmodel.apply, params=v["params"],
        tx=optax.sgd(LR, momentum=0.9),
        model_state={"batch_stats": v["batch_stats"]}))
    j_losses = []
    for b in batches:
        jstate, m = jstep(jstate, jdp.shard_batch(b))
        j_losses.append(float(m["loss"]))

    model = _model(variant, fused)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR,
                                              momentum=0.9))
    step = DataParallel(device="cpu").make_train_step_with_stats(
        tres.make_loss_fn(model, WD))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"].item())
    assert model.training and state.step == 2
    np.testing.assert_allclose(losses, j_losses, **OUT_TOL)
    params, stats = bridge.resnet_to_flax(model.state_dict())
    _assert_trees_close(params, jax.tree.map(np.asarray, jstate.params),
                        atol=1e-6, rtol=1e-6)
    _assert_trees_close(stats, jax.tree.map(
        np.asarray, jstate.model_state["batch_stats"]), **STAT_TOL)


@pytest.mark.parametrize("variant,fused", CASES, ids=IDS)
def test_remat_gives_the_loss_gradients_and_statistics_of_no_remat(
        variant, fused):
    """The recomputation in the backward updates the running statistics
    no second time."""
    batch = _torch(_batch(VARIANTS[variant]["size"], seed=5))
    out = []
    for remat in (False, True):
        model = _model(variant, fused, remat=remat).train()
        (loss, _), grads = value_and_grad(tres.make_loss_fn(model), model,
                                          batch)
        out.append((loss, grads, model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = out
    torch.testing.assert_close(l1, l0, atol=0, rtol=1e-7)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-8, rtol=1e-7)
    for n in s0:
        torch.testing.assert_close(s1[n], s0[n], atol=0, rtol=1e-7)


def test_eval_step_with_stats_restores_the_mode_and_writes_nothing():
    model = _model("stem").train()
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(32, seed=6)
    mets = DataParallel(device="cpu").make_eval_step_with_stats(
        tres.make_metric_fn(model))(state, batch)
    assert model.training and not mets["loss"].requires_grad
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k
    v = _variables("stem")
    want = jax.jit(jres.make_metric_fn(_jmodel("stem")))(
        v["params"], {"batch_stats": v["batch_stats"]}, batch)
    np.testing.assert_allclose(mets["loss"].item(), float(want["loss"]),
                               **OUT_TOL)
    assert mets["accuracy"].item() == float(want["accuracy"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_flops_equal_the_jax_count(variant):
    size = VARIANTS[variant]["size"]
    image = _batch(size)["image"]
    v = _variables(variant)
    jmodel = _jmodel(variant)
    want = jflops.traced_matmul_flops(
        lambda x: jmodel.apply(v, x, train=False), jnp.asarray(image))
    model = _model(variant).eval()
    with torch.no_grad():
        got = flop_accounting.traced_matmul_flops(model,
                                                  torch.as_tensor(image))
    assert got == want > 0


def test_layouts_are_shared_and_the_bridge_is_exact():
    """Plain and fused BatchNorm share one state dict layout (no
    ``num_batches_tracked``); the bridge's round trip is exact."""
    for variant in VARIANTS:
        plain, fused = _model(variant), _model(variant, fused=True)
        assert plain.state_dict().keys() == fused.state_dict().keys()
        assert not any("num_batches" in k for k in plain.state_dict())
        v = _variables(variant)
        params, stats = bridge.resnet_to_flax(plain.state_dict())
        _assert_trees_close(params, v["params"], atol=0, rtol=0)
        _assert_trees_close(stats, v["batch_stats"], atol=0, rtol=0)
        assert all(p.is_contiguous(memory_format=torch.channels_last)
                   for p in plain.parameters() if p.ndim == 4)


def test_resnet50_has_the_parameters_of_the_jax_model():
    jmodel = jres.ResNet50(num_classes=1000, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(p.shape)) for p in
               jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = tres.ResNet50(num_classes=1000)
    assert sum(p.numel() for p in model.parameters()) == want
    assert 25.5e6 < want < 25.7e6


def test_init_weights_draws_flax_defaults():
    model = tres.ResNet18ish(num_classes=10, num_filters=8,
                             dtype=torch.float32).init_weights(3)
    again = tres.ResNet18ish(num_classes=10, num_filters=8,
                             dtype=torch.float32).init_weights(3)
    for (n, p), q in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(p, q), n
    for blk in model.blocks:
        assert torch.all(blk.bn2.weight == 0)
        assert torch.all(blk.bn0.weight == 1)
    w = model.blocks[3].conv1.weight  # fan_in 64 * 9
    assert abs(w.std().item() - (1 / 576) ** 0.5) < 0.1 * (1 / 576) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / 576) ** 0.5 / 0.8796 + 1e-6
