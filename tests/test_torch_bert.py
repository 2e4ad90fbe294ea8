"""The port's BERT classification (``bert_base``, ``num_classes``, the
``classifier`` head, ``make_cls_loss_fn``, AdamW), held to the JAX package
on the same weights and batches.

Geometry: ``bert_base(num_classes=2)`` cut to the port's test geometry
(vocab 256, 2 layers, 2 heads, d_model 32, d_ff 64, max_len 128), batch
4, sequence 64, float32; ``attn_impl="auto"`` resolves to dense attention
on both sides (not causal). Weights cross through
``bridge.params_from_flax`` / ``params_to_flax``; the JAX side runs under
``jax.jit``.

Tolerances, float32 throughout: logits and losses 2e-5 absolute and 1e-5
relative; gradients 2e-5 absolute and 1e-4 relative (both sides sum the
same products in other orders); parameters after two AdamW steps at
weight decay 1e-4 1e-6 (optax and torch.optim order the same arithmetic
differently); the bridge's round trip exact.
"""

import dataclasses
import functools
import inspect

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.serve.engine import ServeEngine
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

CUT = dict(vocab_size=256, num_layers=2, num_heads=2, d_model=32, d_ff=64,
           max_len=128)
JCFG = dataclasses.replace(jtf.bert_base(num_classes=2, dtype=jnp.float32),
                           **CUT)
TCFG = dataclasses.replace(ttf.bert_base(num_classes=2, dtype=torch.float32),
                           **CUT)
OUT_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
LR = 1e-3


@pytest.fixture(scope="module")
def jparams():
    params = jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, fnn.meta.unbox(params))


def _model(jparams):
    m = ttf.Transformer(TCFG)
    m.load_state_dict(bridge.params_from_flax(jparams, TCFG))
    return m


def _batch(seed, b=4, s=64):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 256, (b, s)).astype(np.int32)
    return {"tokens": tokens, "label": (tokens[:, 0] % 2).astype(np.int32)}


def _torch(batch):
    return {k: torch.as_tensor(v, dtype=torch.long)
            for k, v in batch.items()}


def _assert_trees_close(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(leaf, np.asarray(flat[path]),
                                   err_msg=str(path), **tol)


def test_bert_base_is_the_jax_config():
    j, t = jtf.bert_base(), ttf.bert_base()
    for f in ("vocab_size", "num_layers", "num_heads", "d_model", "d_ff",
              "max_len", "causal", "num_classes"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.vocab_size, t.num_classes, t.causal) == (30592, 2, False)
    assert t.resolve_attn_impl(128) == j.resolve_attn_impl(128) == "dense"


def test_classification_logits_match_jax(jparams):
    batch = _batch(1)
    want = jax.jit(jtf.Transformer(JCFG).apply)({"params": jparams},
                                                batch["tokens"])
    model = _model(jparams)
    assert not hasattr(model, "lm_head")
    with torch.no_grad():
        got = model(_torch(batch)["tokens"])
    assert got.dtype == torch.float32 and got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_cls_loss_accuracy_and_every_gradient_match_jax(jparams):
    batch = _batch(2)
    (j_loss, j_mets), j_grads = jax.jit(jax.value_and_grad(
        jtf.make_cls_loss_fn(jtf.Transformer(JCFG)), has_aux=True))(
        jparams, batch)
    model = _model(jparams)
    (loss, mets), grads = value_and_grad(ttf.make_cls_loss_fn(model), model,
                                         _torch(batch))
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    assert mets["accuracy"].item() == float(j_mets["accuracy"])
    _assert_trees_close(bridge.params_to_flax(grads, TCFG), j_grads,
                        **GRAD_TOL)


def test_adamw_at_the_optax_default_decay_matches_optax(jparams):
    """``optax.adamw(lr)`` decays at 1e-4 by default, torch's AdamW at
    1e-2: the port passes 1e-4. Two steps through the data-parallel step
    on the same batches."""
    assert inspect.signature(optax.adamw).parameters[
        "weight_decay"].default == 1e-4
    batches = [_batch(3), _batch(4)]
    loss_fn = jtf.make_cls_loss_fn(jtf.Transformer(JCFG))
    tx = optax.adamw(LR)
    params, opt = jparams, tx.init(jparams)
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    for b in batches:
        updates, opt = tx.update(grad(params, b), opt, params)
        params = optax.apply_updates(params, updates)
    model = _model(jparams)
    state = TrainState(model, torch.optim.AdamW(model.parameters(), lr=LR,
                                                weight_decay=1e-4))
    step = DataParallel(device="cpu").make_train_step(
        ttf.make_cls_loss_fn(model))
    for b in batches:
        state, _ = step(state, b)
    _assert_trees_close(bridge.params_to_flax(model.state_dict(), TCFG),
                        jax.tree.map(np.asarray, params), atol=1e-6,
                        rtol=1e-6)


def test_bridge_round_trip_is_exact(jparams):
    back = bridge.params_to_flax(_model(jparams).state_dict(), TCFG)
    assert "classifier" in back and "lm_head" not in back
    _assert_trees_close(back, jparams, atol=0, rtol=0)


def test_init_weights_builds_a_classifier():
    model = ttf.Transformer(TCFG).init_weights(0)
    assert model.classifier.weight.shape == (2, 32)
    assert torch.all(model.classifier.bias == 0)
    with torch.no_grad():
        out = model(torch.zeros(2, 16, dtype=torch.long))
    assert out.shape == (2, 2) and torch.isfinite(out).all()


@pytest.mark.parametrize("view", ["engine", "generator", "decode_config"])
def test_serving_views_refuse_a_classification_config(jparams, view):
    model = _model(jparams)
    call = {
        "engine": functools.partial(
            ServeEngine, TCFG, model, slots=2, num_blocks=17, block_size=8,
            prefill_chunk=8, device="cpu"),
        "generator": functools.partial(
            tgen.make_generate_fn, TCFG, max_new_tokens=4, device="cpu"),
        "decode_config": functools.partial(tgen.decode_config, TCFG),
    }[view]
    with pytest.raises(ValueError, match="classification"):
        call()
