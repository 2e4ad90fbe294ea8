"""The port's training path (attention impl and remat knobs, the LM loss
and its fused head, the precision presets, the train state, data-parallel
step, hooks and loop), held to the JAX package on the same weights and
batches.

Geometry is the serve CLI's (vocab 256, 2 layers, 2 heads, d_model 32,
d_ff 64, float32) with max_len 128, so that the JAX flash kernels run (in
Pallas interpret mode) at S = 128. Weights cross through
``bridge.params_from_flax`` / ``params_to_flax``; tokens are numpy.

Tolerances, float32 throughout: losses 1e-5 absolute; logits 2e-5
absolute and 1e-5 relative; gradients 2e-5 absolute and 1e-4 relative
(both sides sum the same products in other orders); parameters after one
Adam step 1e-6 (optax and torch.optim order the same arithmetic
differently); the five-step loss curve 1e-4 (Adam normalises each step,
so rounding differences of the gradients grow a little each step).
"""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from distributed_tensorflow_guide_tpu.core import precision as jprec
from distributed_tensorflow_guide_tpu.core.mesh import single_device_mesh
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.ops import fused_ce as jce
from distributed_tensorflow_guide_tpu.parallel.data_parallel import (
    DataParallel as JDataParallel,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core import precision
from distributed_tensorflow_guide_tpu_torch.core.dist import is_chief
from distributed_tensorflow_guide_tpu_torch.core import mesh as tmesh
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    MeshSpec,
    build_mesh,
)
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.ops import fused_ce
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    accumulate_grads,
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.train import hooks
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

GEOM = dict(vocab_size=256, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_len=128, causal=True)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32, attn_impl="flash")
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32, attn_impl="flash")
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
LR = 1e-2


@pytest.fixture(autouse=True)
def _isolated_table(isolated_autotune_table):
    yield


@pytest.fixture(scope="module")
def jparams():
    return jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _model(jparams, cfg=TCFG):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    m = ttf.Transformer(cfg)
    m.load_state_dict(bridge.params_from_flax(tree, cfg))
    return m


def _tokens(seed, b=2, s=128):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _batch(tokens):
    return {"tokens": torch.as_tensor(tokens, dtype=torch.long)}


def _flax_tree(grads):
    """Port gradients ({name: tensor}) in the flax param layout."""
    return bridge.params_to_flax(grads, TCFG)


def _assert_trees_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(leaf, np.asarray(flat[path]),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("attn_impl", ["auto", "dense", "flash"])
def test_resolve_attn_impl_agrees_with_jax(attn_impl):
    for causal in (True, False):
        for s in (None, 64, 1000, 1023, 1024, 4096):
            kw = dict(causal=causal, attn_impl=attn_impl)
            j = jtf.TransformerConfig(**kw).resolve_attn_impl(s)
            assert ttf.TransformerConfig(**kw).resolve_attn_impl(s) == j


def test_config_validates_the_new_knobs_as_jax_does():
    for bad in (dict(attn_impl="Flash"), dict(remat_mode="full")):
        with pytest.raises(ValueError):
            jtf.TransformerConfig(**bad)
        with pytest.raises(ValueError):
            ttf.TransformerConfig(**bad)
    # the port keeps only the explicit mode; JAX's legacy bool is None
    assert ttf.TransformerConfig().remat_mode == "none"
    assert jtf.TransformerConfig().resolved_remat_mode == "none"
    with pytest.raises(ValueError):
        ttf.TransformerConfig(remat_mode=None)


@pytest.mark.parametrize("mode", ["none", "attention", "block"])
def test_remat_mode_means_what_it_means_in_jax(mode):
    assert (ttf.TransformerConfig(remat_mode=mode).remat_mode
            == jtf.TransformerConfig(remat_mode=mode).resolved_remat_mode)


def test_flash_logits_match_jax(jparams):
    tokens = _tokens(1)
    want = jtf.Transformer(JCFG).apply({"params": jparams},
                                       jnp.asarray(tokens))
    with torch.no_grad():
        got = _model(jparams)(torch.as_tensor(tokens, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    with torch.no_grad():
        hidden = _model(jparams)(torch.as_tensor(tokens, dtype=torch.long),
                                 return_hidden=True)
    want_h = jtf.Transformer(JCFG).apply(
        {"params": jparams}, jnp.asarray(tokens), return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_h),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_lm_loss_and_every_gradient_match_jax(jparams, fused):
    """fused_ce pinned the same way on both sides; ce_chunk 100 leaves a
    ragged last chunk of 56 of the 256 vocab columns."""
    tokens = _tokens(2)
    j_loss_fn = jtf.make_lm_loss_fn(jtf.Transformer(JCFG), fused_ce=fused,
                                    ce_chunk=100)
    (j_loss, j_mets), j_grads = jax.value_and_grad(j_loss_fn, has_aux=True)(
        jparams, {"tokens": jnp.asarray(tokens)})
    model = _model(jparams)
    loss_fn = ttf.make_lm_loss_fn(model, fused_ce=fused, ce_chunk=100)
    (loss, mets), grads = value_and_grad(loss_fn, model, _batch(tokens))
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5)
    np.testing.assert_allclose(mets["perplexity"].item(),
                               float(j_mets["perplexity"]), rtol=1e-5)
    _assert_trees_close(_flax_tree(grads),
                        fnn.meta.unbox(j_grads), **GRAD_TOL)


def test_fused_cross_entropy_matches_jax_with_a_ragged_chunk():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 5, 16).astype(np.float32)
    w = (0.3 * rng.randn(16, 50)).astype(np.float32)
    t = rng.randint(0, 50, (6, 5))

    def j_loss(x, w):
        return jce.fused_cross_entropy(x, w, jnp.asarray(t), chunk=16)

    jl, (jdx, jdw) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = fused_ce.fused_cross_entropy(tx, tw, torch.from_numpy(t),
                                        chunk=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **GRAD_TOL)
    # the sum reduction and the unfused loss say the same
    total = fused_ce.fused_cross_entropy(tx, tw, torch.from_numpy(t),
                                         chunk=7, reduction="sum")
    ref = torch.nn.functional.cross_entropy(
        (tx @ tw).reshape(-1, 50), torch.from_numpy(t).reshape(-1),
        reduction="sum")
    torch.testing.assert_close(total, ref, atol=1e-4, rtol=1e-6)


def test_fused_ce_auto_resolves_on_for_the_card_only():
    assert fused_ce.resolve_fused_ce("auto", vocab_size=50304,
                                     platform="cuda") is True
    assert fused_ce.resolve_fused_ce("auto", vocab_size=50304,
                                     platform="cpu") is False
    assert fused_ce.resolve_fused_ce("auto", vocab_size=256,
                                     platform="cuda") is False
    assert fused_ce.resolve_fused_ce("on") is True
    with pytest.raises(ValueError):
        fused_ce.resolve_fused_ce("maybe")
    assert fused_ce.DEFAULT_CE_CHUNK == jce.DEFAULT_CE_CHUNK


@pytest.mark.parametrize("mode", ["attention", "block"])
def test_remat_modes_give_the_grads_of_none(jparams, mode):
    tokens = _batch(_tokens(4))
    base = _model(jparams)
    (l0, _), g0 = value_and_grad(ttf.make_lm_loss_fn(base), base, tokens)
    remat = base.with_config(dataclasses.replace(TCFG, remat_mode=mode))
    (l1, _), g1 = value_and_grad(ttf.make_lm_loss_fn(remat), remat, tokens)
    assert l0.item() == l1.item()
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-7, rtol=1e-6)


def test_precision_presets_mirror_jax():
    assert set(precision.PRESETS) == {"f32", "bf16", "bf16_remat",
                                      "bf16_remat_attn"}
    assert precision.REMAT_MODES == jprec.REMAT_MODES
    for name, pol in precision.PRESETS.items():
        jpol = jprec.PRESETS[name]
        assert pol.remat == jpol.remat
        assert pol.compute_dtype == (torch.float32 if jpol.compute_dtype
                                     == jnp.float32 else torch.bfloat16)
        cfg = pol.apply_to_transformer(TCFG)
        jcfg = jpol.apply_to_transformer(JCFG)
        assert cfg.remat_mode == jcfg.resolved_remat_mode
    assert precision.resolve(None).name == "bf16"
    with pytest.raises(ValueError):
        precision.resolve("bf17")


def test_one_adam_step_matches_optax(jparams):
    model = _model(jparams)
    rng = np.random.RandomState(5)
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    j_grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                           tree)
    tx = optax.adam(LR)
    updates, _ = tx.update(j_grads, tx.init(tree), tree)
    want = optax.apply_updates(tree, updates)
    grads = bridge.params_from_flax(j_grads, TCFG)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    state = state.apply_gradients(grads)
    assert state.step == 1
    _assert_trees_close(bridge.params_to_flax(model.state_dict(), TCFG),
                        want, atol=1e-6, rtol=1e-6)


def test_five_train_steps_match_the_jax_data_parallel_step(jparams):
    batches = [_tokens(10 + i) for i in range(5)]
    jmodel = jtf.Transformer(JCFG)
    jdp = JDataParallel(single_device_mesh())
    jstep = jdp.make_train_step(jtf.make_lm_loss_fn(jmodel, fused_ce=False),
                                donate=False)
    jstate = jdp.replicate(train_state.TrainState.create(
        apply_fn=jmodel.apply, params=jparams, tx=optax.adam(LR)))
    j_losses = []
    for b in batches:
        jstate, m = jstep(jstate, jdp.shard_batch({"tokens": b}))
        j_losses.append(float(m["loss"]))

    model = _model(jparams)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    dp = DataParallel(device="cpu")
    step = dp.make_train_step(ttf.make_lm_loss_fn(model, fused_ce=False))
    seen = []

    class Record(hooks.BaseHook):
        def after_step(self, step, metrics):
            assert metrics["loss"].ndim == 0
            seen.append(metrics["loss"].item())

    loop = TrainLoop(step, state, ({"tokens": b} for b in batches),
                     hooks=[Record()], device="cpu")
    final = loop.run()
    assert final is state and state.step == 5 and loop.step == 5
    np.testing.assert_allclose(seen, j_losses, atol=1e-4)


def test_accum_steps_two_equals_the_full_batch(jparams):
    batch = _batch(_tokens(6, b=4))
    model = _model(jparams)
    loss_fn = ttf.make_lm_loss_fn(model)
    (loss, _), full = value_and_grad(loss_fn, model, batch)
    micro = {"tokens": batch["tokens"].reshape(2, 2, -1)}
    mean, (losses, mets) = accumulate_grads(loss_fn, model, micro, 2)
    assert losses.shape == (2,) and mets["perplexity"].shape == (2,)
    torch.testing.assert_close(losses.mean(), loss, atol=1e-6, rtol=1e-6)
    for n in full:
        torch.testing.assert_close(mean[n], full[n], atol=1e-7, rtol=1e-5)

    def sgd_step(accum):
        m = _model(jparams)
        st = TrainState(m, torch.optim.SGD(m.parameters(), lr=0.1))
        step = DataParallel(device="cpu").make_train_step(
            ttf.make_lm_loss_fn(m), accum_steps=accum)
        _, mets = step(st, batch)
        return mets["loss"], m.state_dict()

    (l1, p1), (l2, p2) = sgd_step(1), sgd_step(2)
    torch.testing.assert_close(l2, l1, atol=1e-6, rtol=1e-6)
    for n in p1:
        torch.testing.assert_close(p2[n], p1[n], atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        DataParallel(device="cpu").make_train_step(
            loss_fn, accum_steps=3)(TrainState(model, torch.optim.SGD(
                model.parameters(), lr=0.1)), batch)


def test_stop_hook_jsonl_hook_and_dispatch_stats(jparams, tmp_path):
    model = _model(jparams)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    step = DataParallel(device="cpu").make_train_step(
        ttf.make_lm_loss_fn(model))
    path = tmp_path / "m.jsonl"
    loop = TrainLoop(step, state, iter(lambda: {"tokens": _tokens(7)},
                                       None),
                     hooks=[hooks.StopAtStepHook(3),
                            hooks.MetricsJSONLHook(path),
                            hooks.LoggingHook(every_steps=1),
                            hooks.StepCounterHook(every_steps=1,
                                                  batch_size=2)],
                     device="cpu")
    loop.run()
    assert loop.step == 3 and loop.should_stop
    assert loop.stop_reason == "hook"
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["perplexity"] > 1 for r in recs)
    stats = loop.dispatch_stats.as_dict()
    assert stats["dispatches"] == stats["opt_steps"] == 3
    assert stats["host_gap_s"] >= 0
    # a resumed, already finished run takes no step
    again = TrainLoop(step, state, iter(lambda: {"tokens": _tokens(7)},
                                        None),
                      hooks=[hooks.StopAtStepHook(3)], start_step=3,
                      device="cpu")
    again.run()
    assert again.dispatch_stats.dispatches == 0
    assert is_chief()


def test_loop_emits_spans_to_a_flight_recorder(jparams):
    from distributed_tensorflow_guide_tpu_torch.obs.events import (
        FlightRecorder,
    )

    model = _model(jparams)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    step = DataParallel(device="cpu").make_train_step(
        ttf.make_lm_loss_fn(model))
    rec = FlightRecorder(capacity=64)
    TrainLoop(step, state, [{"tokens": _tokens(8)}] * 2, recorder=rec,
              device="cpu").run()
    names = [(e.kind, e.payload["name"]) for e in rec.events()]
    assert names.count(("span.begin", "dispatch")) == 2
    assert names.count(("span.end", "data_wait")) == 3  # + the exhausted one


def _in_single_device_mesh(fn):
    with tmesh.single_device_mesh():
        return fn()


@pytest.mark.parametrize("call,item", [
    # ported since (tensor parallelism): on a model axis of one rank the
    # vocab-parallel loss is the plain one, ln 8 for a zero kernel
    (lambda: _in_single_device_mesh(lambda: fused_ce.fused_cross_entropy(
        torch.zeros(2, 4), torch.zeros(4, 8), torch.zeros(2),
        axis="model")), None),
    (lambda: precision.resolve("int8"), "item 9"),
    (lambda: precision.resolve("fp8"), "item 9"),
], ids=["vocab_parallel_ce", "int8", "fp8"])
def test_deferred_knobs_raise_naming_their_roadmap_item(call, item):
    if item is None:
        assert call().item() == pytest.approx(np.log(8), rel=1e-6)
        return
    with pytest.raises(NotImplementedError, match=item):
        call()


def test_data_parallel_takes_a_process_group_of_one_rank(jparams, tmp_path):
    """A mesh over a process group of one rank is the world of one: the
    step's all-reduce moves nothing and the step gives the step without a
    mesh, bit for bit."""
    import torch.distributed as dist

    batch = {"tokens": _tokens(12)}

    def one_step(mesh):
        m = _model(jparams)
        st = TrainState(m, torch.optim.SGD(m.parameters(), lr=0.1))
        _, mets = DataParallel(mesh, device="cpu").make_train_step(
            ttf.make_lm_loss_fn(m))(st, batch)
        return mets["loss"], m.state_dict()

    want_loss, want = one_step(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = build_mesh(MeshSpec(data=-1))
        assert mesh.axis("data").size == 1 and is_chief()
        loss, got = one_step(mesh)
    finally:
        dist.destroy_process_group()
    assert loss.item() == want_loss.item()
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_entry_points_default_to_the_card():
    """``device=None`` means the first CUDA card; without one the training
    entry points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        assert DataParallel().device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(None, None, [])


def test_a_model_on_another_device_is_refused(jparams):
    model = _model(jparams)
    dp = DataParallel(device="cpu")
    dp.device = torch.device("meta")  # a step built for another device
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(ValueError, match="lives on"):
        dp.make_train_step(ttf.make_lm_loss_fn(model))(
            state, {"tokens": _tokens(9)})


def test_eval_step_runs_without_gradients_and_matches_the_loss(jparams):
    model = _model(jparams)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    loss_fn = ttf.make_lm_loss_fn(model)
    dp = DataParallel(device="cpu")

    def metric_fn(module, batch):
        loss, mets = loss_fn(module, batch)
        return {"loss": loss, **mets}

    tokens = _tokens(11)
    mets = dp.make_eval_step(metric_fn)(state, {"tokens": tokens})
    assert not mets["loss"].requires_grad
    (want, _), _ = value_and_grad(loss_fn, model, _batch(tokens))
    assert mets["loss"].item() == want.item()
