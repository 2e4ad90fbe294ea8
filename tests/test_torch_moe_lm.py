"""The port's Switch LM (``models/moe_lm.py``) held to the JAX package's on
the same weights (``bridge.switch_lm_from_flax``), on the CPU: loss and
gradients at data 1 x expert 1 in this process and at data 2 x expert 2
over gloo (one 4-rank job) against the reference on the same mesh of fake
CPU devices, Switch top-2 and dropless top-1.

The reference's gradients come out of its train step as the state of an
optax transformation that keeps them. Under ``shard_map(check_vma=
False)`` its ``psum`` transposes to a psum, so its gradients are the
token shards' count n times the global loss's (n = 4 at 2 x 2); the
port's are the global loss's, held to the reference's / n, and at 2 x 2
to the port's own 1 x 1 gradients on the union batch where the function
is the same (dropless).

Tolerances (f32): losses rtol 1e-5; each gradient's difference within
1e-4 of its norm (products and sums in other orders).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_guide_tpu.core.mesh import MeshSpec as JMeshSpec
from distributed_tensorflow_guide_tpu.core.mesh import build_mesh as jbuild
from distributed_tensorflow_guide_tpu.models import moe_lm as jmoe
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.models.moe_lm import SwitchLM
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from tests import torch_mp_workers as W

JCFG = jtf.TransformerConfig(**W.ML_GEOM, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**W.ML_GEOM, dtype=torch.float32)
REL = 1e-4


def _jmesh(n):
    return jbuild(JMeshSpec(data=n, expert=n), devices=jax.devices()[:n * n])


def _host(params):
    return jax.tree.map(np.asarray, fnn.meta.unbox(params))


@pytest.fixture(scope="module")
def jparams():
    lm = jmoe.SwitchLM(_jmesh(1), JCFG, num_experts=W.ML_E)
    return _host(lm.init_params(jax.random.PRNGKey(3)))


# an optax transformation that keeps the reduced gradients as its state
# (and updates nothing): the reference's train step hands them back
_KEEP = optax.GradientTransformation(
    lambda p: jax.tree.map(jnp.zeros_like, p),
    lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jgrads(n, router, top_k, params, fused=False):
    """The reference's loss and reduced gradients on a data n x expert n
    mesh."""
    lm = jmoe.SwitchLM(_jmesh(n), JCFG, num_experts=W.ML_E, top_k=top_k,
                       router=router, fused_ce=fused, ce_chunk=16)
    p = jax.device_put(params, lm.param_shardings())
    step = lm.make_train_step(_KEEP, p, donate=False)
    grads, _, m = step(lm.init_opt_state(_KEEP, p), p,
                       jnp.asarray(W.ml_tokens(), jnp.int32))
    return float(m["loss"]), _host(grads)


def _tgrads(router, top_k, full, fused=False):
    lm = SwitchLM(single_device_mesh(), TCFG, W.ML_E, top_k=top_k,
                  router=router, fused_ce=fused, ce_chunk=16, device="cpu")
    module = lm.shard_params(full)
    loss, mets, grads = lm.loss_and_grads(module, W.ml_tokens())
    return loss.item(), grads


def _close(got: dict, want: dict, scale: float = 1.0):
    for n, w in want.items():
        g = np.asarray(got[n], np.float64) * scale
        w = np.asarray(w, np.float64)
        gap = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert gap < REL, (n, gap)


@pytest.mark.parametrize("router,top_k", W.ML_CASES)
def test_one_rank_loss_and_gradients_match_the_reference(jparams, router,
                                                         top_k):
    full = bridge.switch_lm_from_flax(jparams, TCFG)
    loss, grads = _tgrads(router, top_k, full)
    jloss, jgrads = _jgrads(1, router, top_k, jparams)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _close(grads, bridge.switch_lm_from_flax(jgrads, TCFG))


def test_fused_ce_matches_naive(jparams):
    """tests/test_fused_ce.py:320 on the port: the fused head gives the
    naive one's loss and gradients (and the reference's fused ones)."""
    full = bridge.switch_lm_from_flax(jparams, TCFG)
    l0, g0 = _tgrads("switch", 2, full, fused=False)
    l1, g1 = _tgrads("switch", 2, full, fused=True)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    _close(g1, {n: g.numpy().astype(np.float64) for n, g in g0.items()})
    jl, jg = _jgrads(1, "switch", 2, jparams, fused=True)
    np.testing.assert_allclose(l1, jl, rtol=1e-5)
    _close(g1, bridge.switch_lm_from_flax(jg, TCFG))


def test_bridge_round_trips_the_stacked_tree(jparams):
    back = bridge.switch_lm_to_flax(bridge.switch_lm_from_flax(jparams,
                                                               TCFG), TCFG)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, leaf), path


def test_single_expert_equals_the_dense_ffn():
    """tests/test_moe_lm.py:28 on the port: one expert, gate 1, no drops:
    the LM equals the same blocks with a plain FFN on the same weights."""
    lm = SwitchLM(single_device_mesh(), TCFG, 1, top_k=1,
                  capacity_factor=2.0, aux_weight=0.0, fused_ce=False,
                  device="cpu")
    full = lm.init_state_dict(0)
    module = lm.shard_params(full)
    tokens = torch.as_tensor(W.ml_tokens()[:8])
    _, mets, _ = lm.loss_and_grads(module, tokens)
    with torch.no_grad():
        e, h = module.embed, module.head
        x = e.tok_emb(tokens) + e.pos_emb.weight[:tokens.shape[1]]
        for i, blk in enumerate(module.blocks):
            x = x + blk.attn(blk.ln1(x))
            ff = torch.nn.functional.gelu(
                blk.ln2(x) @ module.moe.w_in[i, 0], approximate="tanh")
            x = x + ff @ module.moe.w_out[i, 0]
        logits = h.ln_f(x) @ h.lm_head.weight.t()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        want = -logp.gather(-1, tokens[:, 1:, None]).mean()
    np.testing.assert_allclose(mets["lm_loss"].item(), want.item(),
                               rtol=1e-5)


def test_the_switch_lm_learns():
    lm = SwitchLM(single_device_mesh(), TCFG, W.ML_E, top_k=2,
                  capacity_factor=2.0, device="cpu")
    module = lm.init_params(1)
    step = lm.make_train_step(torch.optim.Adam(module.parameters(), 3e-3))
    losses = [step(module, W.ml_tokens())[1]["lm_loss"].item()
              for _ in range(15)]
    assert losses[-1] < losses[0] * 0.8, losses


def test_refusals():
    with pytest.raises(ValueError, match="router"):
        SwitchLM(single_device_mesh(), TCFG, 8, router="topk-drop",
                 device="cpu")
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        AXES,
        AxisGroup,
        Mesh,
    )

    n = {a: (4 if a == "expert" else 1) for a in AXES}
    mesh = Mesh(n, 0, {a: AxisGroup(a, n[a], 0, (0,)) for a in AXES})
    with pytest.raises(ValueError, match="divisible by expert axis"):
        SwitchLM(mesh, TCFG, 6, device="cpu")


# ---- data 2 x expert 2 over gloo --------------------------------------------


@pytest.fixture(scope="module")
def job(jparams, tmp_path_factory):
    path = tmp_path_factory.mktemp("switch") / "weights.npz"
    np.savez(path, **W.flatten(jparams))
    ranks = mp.run_multiprocess("tests.torch_mp_workers:moe_lm_job", 4,
                                args=(str(path),), timeout=300)
    return [r.result for r in ranks]


def _assemble(job, router) -> dict:
    """The whole model's gradients from the ranks: replicated leaves from
    rank 0, each expert shard from a rank of data index 0."""
    pre = f"{router}/grad/"
    out = {n[len(pre):]: np.asarray(v, np.float64)
           for n, v in job[0].items() if n.startswith(pre)}
    for name in ("moe.w_in", "moe.w_out"):
        parts = sorted((r["expert_index"], np.asarray(r[pre + name]))
                       for r in job if r["data_index"] == 0)
        out[name] = np.concatenate([p for _, p in parts], axis=1)
    return out


@pytest.mark.parametrize("router,top_k", W.ML_CASES)
def test_two_by_two_matches_the_reference_on_the_same_mesh(job, jparams,
                                                           router, top_k):
    jloss, jgrads = _jgrads(2, router, top_k, jparams)
    for r in job:
        np.testing.assert_allclose(r[f"{router}/loss"], jloss, rtol=1e-5)
    got = _assemble(job, router)
    # the reference's gradients are 4x the global loss's
    _close(got, bridge.switch_lm_from_flax(jgrads, TCFG), scale=4.0)
    if router == "dropless":  # the same function as one process's
        _, one = _tgrads(router, top_k,
                         bridge.switch_lm_from_flax(jparams, TCFG))
        _close(got, {n: g.numpy().astype(np.float64)
                     for n, g in one.items()})


def test_moments_are_laid_out_like_their_parameters(job):
    for r in job:
        for key, (moment, param) in ((k, v) for k, v in r.items()
                                     if "/moment/" in k):
            assert moment == param, key
        _, (moment, _) = next((k, v) for k, v in r.items()
                              if k.endswith("/moment/moe.w_in"))
        assert moment[1] == W.ML_E // 2  # this rank's experts only
