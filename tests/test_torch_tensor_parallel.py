"""The port's tensor parallelism held to numpy, to the unsharded model and
to the JAX package's ``TensorParallel``.

One 4-rank gloo job (``tests/torch_mp_workers.py:tensor_parallel_job``,
a (data=2, model=2) mesh) runs every case; the tests compare here:

* ``tp_allreduce`` (``g``) and ``tp_identity`` (``f``): values and
  gradients against numpy sums over each ``model`` pair;
* the ``tp_local`` Transformer on its shards (``TensorParallel.shard``):
  logits and every gradient against the unsharded Transformer on the same
  weights and rows (the LM's logits are the shard's vocabulary columns);
* the vocab-parallel fused CE against the tp = 1 fused CE: the loss, dx
  and the dW shards;
* one ``TensorParallel`` SGD step (data x model = 2 x 2) of the BERT-like
  and the LM-head models (tests/test_tensor_parallel.py's geometries)
  against the JAX ``TensorParallel`` step on a (data, model) mesh over 4
  of the conftest's 8 fake devices, from bridged weights;
* replicated parameters get the same gradient on both ``model`` ranks;
* the flash path under TP (the kernels' plain versions on the CPU)
  against dense attention;
* Megatron sequence parallelism (``rules=MEGATRON_SP_RULES``): the LM's
  loss and gradients against the default rules' on the same weights, one
  SGD step against the JAX ``TensorParallel(rules=MEGATRON_SP_RULES)``
  step, the replicated parameters' gradients summed over ``model``, and
  the gather/scatter pairs' wire bytes against the all-reduces they
  replace.

Tolerances, float32: the f/g pair and the CE case 1e-6 absolute and
relative (sums of two values); the sharded model against the unsharded
one and the flash path against dense 1e-6 absolute, 1e-5 relative (the
shards' partial products summed in another order); against JAX the
tests/test_pipeline.py tolerances, loss ``rtol=1e-5``, parameters after
one SGD 0.1 step ``rtol=1e-4, atol=1e-6``. Replicated gradients across
``model`` are bitwise equal. Sequence-parallel against default-rules
gradients: the sharded-model tolerance (the same partial products, summed
over other slices of the sequence). Wire bytes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state
from jax.sharding import Mesh

from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.parallel.tensor import (
    MEGATRON_SP_RULES as J_SP_RULES,
)
from distributed_tensorflow_guide_tpu.parallel.tensor import (
    TensorParallel as JTensorParallel,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.ops.fused_ce import (
    fused_cross_entropy,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
    DEFAULT_RULES,
    MEGATRON_SP_RULES,
    TensorParallel,
    local_config,
    shard_state_dict,
    split_dim,
)
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from tests import torch_mp_workers as W

TIGHT = dict(atol=1e-6, rtol=1e-6)
SHARD_TOL = dict(atol=1e-6, rtol=1e-5)
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
CASES = {name: (geom, extra, n) for name, geom, extra, n in W.tp_cases()}


@pytest.fixture(scope="module")
def job():
    """Each rank's results, with the JAX steps run while the ranks run."""
    runner = mp.MultiProcessRunner("tests.torch_mp_workers:"
                                   "tensor_parallel_job", 4,
                                   timeout=300).start()
    try:
        jax_steps = {name: _jax_tp_step(name) for name in
                     ("bert", "lm")}
        jax_steps["sp-lm"] = _jax_tp_step("lm", J_SP_RULES)
    finally:
        ranks = [r.result for r in runner.join()]
    return ranks, jax_steps


def _tcfg(name):
    geom, extra, _ = CASES[name]
    return ttf.TransformerConfig(**geom, dtype=torch.float32, **extra)


def _full(name):
    return ttf.Transformer(_tcfg(name)).init_weights(0)


def _jax_tp_step(name, rules=None):
    """The JAX TensorParallel SGD step on the port's initial weights
    (bridged), under ``rules`` (its default when None): (loss, the state
    dict after the step)."""
    geom, _, n = CASES[name]
    cfg = jtf.TransformerConfig(**geom, dtype=jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    tp = JTensorParallel(mesh) if rules is None else JTensorParallel(
        mesh, rules=rules)
    model = jtf.Transformer(cfg)
    _, shardings = tp.init_params(model, jax.random.PRNGKey(0),
                                  jnp.zeros((1, cfg.max_len), jnp.int32))
    tree = bridge.params_to_flax(_full(name).state_dict(), _tcfg(name))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree), shardings)
    state = train_state.TrainState.create(apply_fn=model.apply,
                                          params=params,
                                          tx=optax.sgd(W.TP_LR))
    st = tp.state_shardings(state, shardings)
    loss_fn = (jtf.make_cls_loss_fn(model) if cfg.num_classes
               else jtf.make_lm_loss_fn(model, fused_ce=False))
    step = tp.make_train_step(loss_fn, st, donate=False)
    batch = {k: v.astype(np.int32) for k, v in W.tp_batch(geom, n).items()}
    state, m = step(jax.device_put(state, st), batch)
    return (float(m["loss"]), bridge.params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(state.params)),
        _tcfg(name)))


def _pairs(ranks):
    """The ranks of each ``model`` pair: {data index: [model 0, model 1]}."""
    out = {}
    for r in ranks:
        d, i = r["coords"]
        out.setdefault(d, [None, None])[i] = r
    return out


def _sub(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def test_tp_allreduce_and_tp_identity_values_and_gradients(job):
    """g sums its input over the pair and passes the cotangent through;
    f passes its input through and sums the cotangents over the pair."""
    ranks, _ = job
    for pair in _pairs(ranks).values():
        xs = [W.rank_input(r["rank"], (4, 6)) for r in pair]
        ws = [W.rank_input(r["rank"], (4, 6), seed=100) for r in pair]
        for r, x, w in zip(pair, xs, ws):
            np.testing.assert_allclose(r["g/value"], sum(xs), **TIGHT)
            np.testing.assert_allclose(r["g/grad"], w, **TIGHT)
            np.testing.assert_allclose(r["f/value"], x, **TIGHT)
            np.testing.assert_allclose(r["f/grad"], sum(ws), **TIGHT)
            assert r["fg_trace"]["psum[model]"]["calls"] == 1
            assert r["fg_trace"]["psum_bwd[model]"]["calls"] == 1
            assert r["fg_trace"]["psum_bwd[model]"]["wire"] == 4 * 6 * 4


def test_vocab_parallel_fused_ce_equals_the_tp1_fused_ce(job):
    ranks, _ = job
    cx, ck, ct = (torch.from_numpy(a) for a in W.tp_ce_inputs())
    cx.requires_grad_()
    ck.requires_grad_()
    loss = fused_cross_entropy(cx, ck, ct, chunk=W.TP_CE_CHUNK)
    loss.backward()
    for r in ranks:
        i = r["coords"][1]
        np.testing.assert_allclose(r["ce/loss"], loss.item(), **TIGHT)
        np.testing.assert_allclose(r["ce/dx"], cx.grad.numpy(), **TIGHT)
        np.testing.assert_allclose(
            r["ce/dw"], ck.grad.chunk(2, dim=1)[i].numpy(), **TIGHT)


@pytest.mark.parametrize("name", ["bert", "lm", "lm-fused"])
def test_tp_local_transformer_matches_the_unsharded_one(job, name):
    """Each rank's sharded model gives the unsharded model's logits (its
    vocabulary columns, for the LM) and its shard of every gradient, on
    the rank's rows."""
    ranks, _ = job
    geom, _, n = CASES[name]
    full = _full(name)
    cfg = full.cfg
    if cfg.num_classes:
        loss_fn = ttf.make_cls_loss_fn(full)
    else:
        loss_fn = ttf.make_lm_loss_fn(full, fused_ce=False)
    batch = W.tp_batch(geom, n)
    for r in ranks:
        d, i = r["coords"]
        share = {k: torch.as_tensor(v[d * n // 2:(d + 1) * n // 2])
                 for k, v in batch.items()}
        (loss, _), grads = value_and_grad(loss_fn, full, share)
        with torch.no_grad():
            logits = full(share["tokens"])
        if not cfg.num_classes:
            logits = logits.chunk(2, dim=-1)[i]
        np.testing.assert_allclose(r[f"{name}/logits"], logits.numpy(),
                                   **SHARD_TOL)
        np.testing.assert_allclose(r[f"{name}/loss0"], loss.item(),
                                   **SHARD_TOL)
        got = _sub(r, f"{name}/grad/")
        want = shard_state_dict(grads, 2, i)
        assert got.keys() == want.keys()
        for k, g in want.items():
            np.testing.assert_allclose(got[k], g.numpy(), **SHARD_TOL,
                                       err_msg=f"rank {r['rank']} {k}")


@pytest.mark.parametrize("name,jax_name", [("bert", "bert"), ("lm", "lm"),
                                           ("lm-fused", "lm")])
def test_tp_step_matches_the_jax_tp_step(job, name, jax_name):
    """One SGD step of the port's TensorParallel (the gathered
    parameters, every rank) equals the JAX TensorParallel step's."""
    ranks, jax_steps = job
    want_loss, want = jax_steps[jax_name]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{name}/loss"]), want_loss,
                                   **LOSS_TOL)
        got = _sub(r, f"{name}/param/")
        assert got.keys() == want.keys()
        for k, t in want.items():
            np.testing.assert_allclose(got[k], t.numpy(), **PARAM_TOL,
                                       err_msg=f"rank {r['rank']} {k}")


@pytest.mark.parametrize("name", ["bert", "lm", "lm-fused"])
def test_replicated_parameters_get_identical_gradients(job, name):
    """A replicated parameter's gradient is the full one on both
    ``model`` ranks, through f/g alone: bitwise equal, and no reduction
    is added for it."""
    ranks, _ = job
    for pair in _pairs(ranks).values():
        g0, g1 = (_sub(r, f"{name}/grad/") for r in pair)
        shared = [k for k in g0 if split_dim(k) is None]
        assert shared
        for k in shared:
            np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)


def test_tp_flash_matches_dense(job):
    """The flash path under TP (H/tp heads a rank, the kernels' plain
    versions on the CPU) gives dense attention's loss and step."""
    ranks, _ = job
    for r in ranks:
        np.testing.assert_allclose(r["lm-long-flash/loss"],
                                   r["lm-long-dense/loss"], **SHARD_TOL)
        dense = _sub(r, "lm-long-dense/param/")
        for k, t in _sub(r, "lm-long-flash/param/").items():
            np.testing.assert_allclose(t, dense[k], **SHARD_TOL, err_msg=k)


def test_local_config_and_its_validation():
    cfg = _tcfg("lm")
    sd = _full("lm").state_dict()
    tree = bridge.params_to_flax(sd, cfg)
    for i in range(2):  # the bridge's shards are TensorParallel's
        got = bridge.tp_params_from_flax(tree, cfg, 2, i)
        want = shard_state_dict(sd, 2, i)
        assert got.keys() == want.keys()
        for k, t in want.items():
            torch.testing.assert_close(got[k], t, rtol=0, atol=0)
    local = local_config(cfg, 2)
    assert (local.num_heads, local.d_ff, local.vocab_size) == (2, 32, 64)
    assert local.head_dim == cfg.head_dim and local.tp_axis == "model"
    with pytest.raises(ValueError, match="divide"):
        cfg.tp_local(3)
    with pytest.raises(ValueError, match="vocab_size"):
        local_config(ttf.TransformerConfig(vocab_size=127, num_heads=4,
                                           d_model=32, d_ff=64), 2)


# ---- Megatron sequence parallelism -------------------------------------------


def test_sp_rules_are_the_jax_rules_and_the_only_ones_taken():
    assert MEGATRON_SP_RULES == tuple(J_SP_RULES)
    assert DEFAULT_RULES == tuple(
        ("seq", None) if name == "seq" else (name, axis)
        for name, axis in J_SP_RULES)
    with pytest.raises(ValueError, match="rules"):
        TensorParallel(None, rules=(("batch", "data"),), device="cpu")
    with pytest.raises(ValueError, match="tp_sequence"):
        ttf.TransformerConfig(tp_sequence=True)


@pytest.mark.parametrize("case", ["lm", "lm-fused", "lm-long-flash"])
def test_sp_loss_and_gradients_equal_the_default_rules(job, case):
    """Under MEGATRON_SP_RULES each rank's loss and gradient shards are
    the default rules' (same weights, same rows)."""
    ranks, _ = job
    for r in ranks:
        np.testing.assert_allclose(r[f"sp-{case}/loss0"],
                                   r[f"{case}/loss0"], **SHARD_TOL)
        got, want = _sub(r, f"sp-{case}/grad/"), _sub(r, f"{case}/grad/")
        assert got.keys() == want.keys()
        for k, g in want.items():
            np.testing.assert_allclose(got[k], g, **SHARD_TOL,
                                       err_msg=f"rank {r['rank']} {k}")


@pytest.mark.parametrize("case", ["lm", "lm-fused"])
def test_sp_step_matches_the_jax_sp_step(job, case):
    """One SGD step under the SP rules (the gathered parameters, every
    rank) equals the JAX TensorParallel(rules=MEGATRON_SP_RULES) step."""
    ranks, jax_steps = job
    want_loss, want = jax_steps["sp-lm"]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"sp-{case}/loss"]), want_loss,
                                   **LOSS_TOL)
        got = _sub(r, f"sp-{case}/param/")
        assert got.keys() == want.keys()
        for k, t in want.items():
            np.testing.assert_allclose(got[k], t.numpy(), **PARAM_TOL,
                                       err_msg=f"rank {r['rank']} {k}")


def test_sp_layernorm_and_position_gradients_are_summed_over_model(job):
    """A LayerNorm or ``pos_emb`` sees only its slice of the sequence: its
    gradient on each rank is a part, the two parts sum to the full
    gradient, and the step's psum gives both ranks that sum bitwise."""
    ranks, _ = job
    for pair in _pairs(ranks).values():
        raw = [_sub(r, "sp-lm/rawgrad/") for r in pair]
        synced = [_sub(r, "sp-lm/grad/") for r in pair]
        shared = [k for k in raw[0] if split_dim(k) is None]
        assert "pos_emb.weight" in shared and "ln_f.weight" in shared
        for k in shared:
            np.testing.assert_array_equal(synced[0][k], synced[1][k],
                                          err_msg=k)
            np.testing.assert_allclose(raw[0][k] + raw[1][k], synced[0][k],
                                       **TIGHT, err_msg=k)
            assert not np.allclose(raw[0][k], synced[0][k]), k
        for k in raw[0]:  # the sharded ones need no sum
            if split_dim(k) is not None:
                np.testing.assert_array_equal(raw[0][k], synced[0][k])


@pytest.mark.parametrize("case", ["lm", "lm-fused"])
def test_sp_gather_scatter_bytes_equal_the_allreduces_they_replace(job,
                                                                   case):
    """No psum is left in the blocks under SP: each all-reduce of the
    default rules (``g`` forward, ``f`` backward, the embedding's sum,
    the head input's gradient) became an all-gather and a reduce-scatter
    with the same bytes on the wire. The psums that stay are the loss's
    two forward sums and the replicated gradients' one sum. One
    difference is exact and expected: the fused CE's backward sums dx over
    the S - 1 positions that predict a token, while the head's gather
    under SP moves all S (one position a sequence more)."""
    ranks, _ = job
    cfg = _tcfg(case)
    layers = cfg.num_layers
    rows = CASES[case][2] // 2  # a data rank's sequences
    one_position = rows * cfg.d_model * 4 if case.endswith("fused") else 0
    grad_sync = 4 * sum(  # f32, one psum at 2 ranks: 2P(n-1)/n = P
        t.numel() for n_, t in _full(case).state_dict().items()
        if split_dim(n_) is None)
    for r in ranks:
        d, s = (r[f"sp-{case}/trace/{x}"] for x in ("default", "sp"))
        assert "psum_bwd[model]" not in s
        assert s["psum[model]"]["calls"] == 3
        # g a sub-layer, the embedding, the loss's two (and fused CE's dx)
        assert d["psum[model]"]["calls"] == (
            2 * layers + 3 + case.endswith("fused"))
        # gathers: a sub-layer's input and the head's; scatters: a
        # sub-layer's output and the embedding's
        for k in ("all_gather[model]", "reduce_scatter[model]",
                  "all_gather_bwd[model]", "reduce_scatter_bwd[model]"):
            assert s[k]["calls"] == 2 * layers + 1, k
        pairs = sum(s[k]["wire"] for k in (
            "all_gather[model]", "reduce_scatter[model]",
            "all_gather_bwd[model]", "reduce_scatter_bwd[model]"))
        loss_sums = s["psum[model]"]["wire"] - grad_sync
        assert pairs == (d["psum[model]"]["wire"]
                         + d["psum_bwd[model]"]["wire"] - loss_sums
                         + one_position)


def test_sp_step_with_accumulated_microbatches_sums_the_replicated_gradients(
        job):
    """accum_steps=2 under the SP rules averages two microbatches'
    gradients and still sums the replicated parameters' parts over
    ``model``: one SGD step lands where the whole batch's does."""
    ranks, _ = job
    for r in ranks:
        want = _sub(r, "sp-lm/param/")
        got = _sub(r, "sp-lm-accum2/param/")
        assert got.keys() == want.keys()
        for k, t in want.items():
            np.testing.assert_allclose(got[k], t, **SHARD_TOL,
                                       err_msg=f"rank {r['rank']} {k}")
