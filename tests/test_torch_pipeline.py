"""The port's pipeline parallelism (``parallel/pipeline.py``) held to the
JAX package's ``PipelinedLM``.

* The three static schedule tables equal the JAX package's, entry for
  entry, at the (M, P) and (M, P, v) cases of ``tests/test_pipeline.py``.
* One 4-rank gloo job (``tests/torch_mp_workers.py:pipeline_job``) runs
  the port's ``PipelinedLM`` on each case of ``W.PP_CASES``: GPipe and
  1F1B at pipe 4, 1F1B at pipe 2 x data 2, interleaved GPipe and 1F1B at
  pipe 2, v 2 (x data 2), and pipe 2 x model 2 under 1F1B with the fused
  vocab-parallel CE and under GPipe with the naive one. The JAX side runs
  the same case on a ``jax.sharding.Mesh`` (data, pipe, model) over 4 of
  the conftest's 8 fake devices, while the ranks run, from the same
  weights: the test writes each layout's JAX host tree
  (``bridge.pipeline_params_to_flax``) and each rank takes its stage
  from it (``bridge.pipeline_stage_from_flax``).

Tolerances are the JAX test's own, float32: the loss ``rtol=1e-5``; the
parameters after one SGD 0.1 step ``rtol=1e-4, atol=1e-6``. The serving
model's logits against the JAX Transformer on the same weights: 1e-5
absolute and relative. Wire bytes are exact; the copies that must stay
equal (embedding and head across ``pipe``, replicated parameters across
``model``) are bitwise equal.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.parallel import pipeline as jpl
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel import pipeline as tpl
from distributed_tensorflow_guide_tpu_torch.parallel.tensor import split_dim
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from tests import torch_mp_workers as W

TCFG = ttf.TransformerConfig(**W.PP_GEOM, dtype=torch.float32)
JCFG = jtf.TransformerConfig(**W.PP_GEOM, dtype=jnp.float32)
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
NAMES = [c[0] for c in W.PP_CASES]


# ---- the schedule tables -------------------------------------------------------


def _same_table(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("M,P", [(4, 4), (8, 4), (2, 4), (1, 2), (6, 2),
                                 (8, 8)])
def test_1f1b_table_equals_the_jax_one(M, P):
    _same_table(tpl._make_1f1b_schedule(M, P), jpl._make_1f1b_schedule(M, P))


@pytest.mark.parametrize("M,P,v", [(4, 2, 2), (8, 4, 2), (4, 4, 4),
                                   (8, 4, 1), (8, 2, 4), (1, 2, 2)])
def test_interleaved_table_equals_the_jax_one(M, P, v):
    _same_table(tpl._make_interleaved_schedule(M, P, v),
                jpl._make_interleaved_schedule(M, P, v))


@pytest.mark.parametrize("M,P,v", [(4, 2, 2), (8, 4, 2), (8, 2, 4),
                                   (16, 4, 2), (32, 4, 2)])
def test_interleaved_1f1b_table_equals_the_jax_one(M, P, v):
    _same_table(tpl._make_interleaved_1f1b_schedule(M, P, v),
                jpl._make_interleaved_1f1b_schedule(M, P, v))


# ---- the 4-rank job and the JAX cases ------------------------------------------


def _jax_case(case, full_sd):
    """The JAX PipelinedLM's step on the case's host tree: (loss, the
    flat state dict after the step, the closed form of
    ppermute_bytes_per_step(mb))."""
    name, n_data, P, tp, schedule, v, fused = case
    tree = bridge.pipeline_params_to_flax(full_sd, TCFG, P, v)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(n_data, P, tp),
                ("data", "pipe", "model"))
    pp = jpl.PipelinedLM(mesh, JCFG, num_microbatches=W.PP_M,
                         schedule=schedule, virtual_chunks=v,
                         fused_ce=fused, ce_chunk=W.PP_CE_CHUNK)
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            pp.param_shardings())
    tx = optax.sgd(W.PP_LR)
    step = pp.make_train_step(tx, params, donate=False)
    _, params2, m = step(pp.init_opt_state(tx, params), params,
                         W.pp_tokens(n_data))
    serving = pp.to_serving_params(jax.device_get(params2))
    return (float(m["loss"]),
            bridge.params_from_flax(jax.tree.map(np.asarray, serving), TCFG),
            pp.ppermute_bytes_per_step(W.PP_MB))


@pytest.fixture(scope="module")
def runs():
    """(each rank's result, {case: the JAX case's result})."""
    full_sd = ttf.Transformer(TCFG).init_weights(0).state_dict()
    with tempfile.TemporaryDirectory(prefix="dtg_pp_") as tmp:
        for case in W.PP_CASES:  # the ranks read these first
            tree = bridge.pipeline_params_to_flax(full_sd, TCFG, case[2],
                                                  case[5])
            np.savez(f"{tmp}/{case[0]}.npz", **W.flatten(tree))
        runner = mp.MultiProcessRunner("tests.torch_mp_workers:pipeline_job",
                                       4, [tmp], timeout=300).start()
        try:
            jax_runs = {c[0]: _jax_case(c, full_sd) for c in W.PP_CASES}
        finally:
            ranks = [r.result for r in runner.join()]
    return ranks, jax_runs


def _case(name):
    return next(c for c in W.PP_CASES + (W.PP_NAIVE_TWIN,) if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
def test_pipeline_step_matches_the_jax_pipeline(runs, name):
    """Every rank reports the JAX step's loss; the parameters after the
    step, gathered by ``to_serving_params``, equal the JAX step's."""
    ranks, jax_runs = runs
    want_loss, want_params, _ = jax_runs[name]
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{name}/loss"]), want_loss,
                                   **LOSS_TOL, err_msg=f"rank {res['rank']}")
    got = {k.split("/serving/")[1]: v for k, v in ranks[0].items()
           if k.startswith(f"{name}/serving/")}
    assert got.keys() == want_params.keys()
    for n, want in want_params.items():
        np.testing.assert_allclose(got[n], want.numpy(), **PARAM_TOL,
                                   err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_stage_and_the_copies_agree(runs, name):
    """A rank's parameters after the step are its shard of the gathered
    state dict; the embedding and head copies are bitwise equal across
    ``pipe``, the replicated parameters across ``model``."""
    ranks, _ = runs
    full = {k.split("/serving/")[1]: torch.as_tensor(v)
            for k, v in ranks[0].items() if k.startswith(f"{name}/serving/")}
    _, n_data, P, tp, _, v, _ = _case(name)
    by_coords = {}
    for res in ranks:
        d, s, i = res[f"{name}/coords"]
        local = {k.split("/local/")[1]: val for k, val in res.items()
                 if k.startswith(f"{name}/local/")}
        by_coords[(d, s, i)] = local
        pp = _rank_view(P, tp, v, s, i)
        for n, want in pp.stage_state_dict(full).items():
            np.testing.assert_array_equal(local[n], want.numpy(), err_msg=n)
    for (d, s, i), local in by_coords.items():
        for n, t in local.items():
            if not n.startswith("chunks."):  # copies on every stage
                np.testing.assert_array_equal(t, by_coords[(d, 0, i)][n])
            if split_dim(n) is None:  # replicated over model
                np.testing.assert_array_equal(t, by_coords[(d, s, 0)][n])


def _rank_view(P, tp, v, stage, shard):
    """A PipelinedLM as the rank at (stage, shard) of a (pipe P, model tp)
    mesh sees it, without process groups: its layout maps only."""
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        AXES,
        AxisGroup,
        Mesh as TMesh,
    )

    sizes = {a: 1 for a in AXES} | {"pipe": P, "model": tp}
    index = {"pipe": stage, "model": shard}
    mesh = TMesh(sizes, 0, {a: AxisGroup(a, sizes[a], index.get(a, 0),
                                         tuple(range(sizes[a])))
                            for a in AXES})
    return tpl.PipelinedLM(mesh, TCFG, W.PP_M, virtual_chunks=v,
                           fused_ce=False, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_pipe_wire_bytes_are_exact(runs, name):
    """Summed over each pipe group, the ranks' ``ppermute[pipe]`` wire
    bytes are 2 · M · act · (P·v − 1); at v = 1 that is P times the JAX
    package's ``ppermute_bytes_per_step``."""
    ranks, jax_runs = runs
    _, n_data, P, tp, _, v, _ = _case(name)
    act = W.PP_MB * TCFG.max_len * TCFG.d_model * 4
    want = 2 * W.PP_M * act * (P * v - 1)
    groups = {}
    for res in ranks:
        d, _, i = res[f"{name}/coords"]
        groups[(d, i)] = groups.get((d, i), 0) + res[f"{name}/wire"]
        assert res[f"{name}/want_wire"] == want
    assert set(groups.values()) == {want}
    if v == 1:
        assert want == pytest.approx(P * jax_runs[name][2], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_pipe_wire_bytes_follow_the_batch_sequence_length(runs, name):
    """On a batch of sequences shorter than ``max_len`` the hand-offs
    carry the batch's S: the traced bytes and
    ``pipe_wire_bytes_per_step(mb, S)`` are 2 · M · act · (P·v − 1) with
    act = mb · S · d_model · itemsize."""
    ranks, _ = runs
    _, n_data, P, tp, _, v, _ = _case(name)
    act = W.PP_MB * W.PP_SHORT_S * TCFG.d_model * 4
    want = 2 * W.PP_M * act * (P * v - 1)
    groups = {}
    for res in ranks:
        d, _, i = res[f"{name}/coords"]
        groups[(d, i)] = groups.get((d, i), 0) + res[f"{name}/short_wire"]
        assert res[f"{name}/short_want_wire"] == want
    assert set(groups.values()) == {want}


@pytest.mark.parametrize("name", NAMES)
def test_eval_step_matches_the_jax_loss(runs, name):
    """The forward-only eval step on the initial weights gives the JAX
    train step's loss (taken before its update) on every rank."""
    ranks, jax_runs = runs
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{name}/eval_loss"]),
                                   jax_runs[name][0], **LOSS_TOL)


@pytest.mark.parametrize("name", ["pipe4-1f1b", "pipe2-v2-gpipe",
                                  "pipe2-model2-1f1b-fused"])
def test_to_serving_params_logits_parity(runs, name):
    """The gathered weights serve: the port's Transformer on them gives
    the JAX Transformer's logits on the same weights, and its loss on the
    union batch is the pipeline's own eval loss after the step."""
    ranks, _ = runs
    res = ranks[0]
    serving = {k.split("/serving/")[1]: torch.as_tensor(v)
               for k, v in res.items() if k.startswith(f"{name}/serving/")}
    tree = bridge.params_to_flax(serving, TCFG)
    tokens = W.pp_tokens(_case(name)[1])
    want = jtf.Transformer(JCFG).apply({"params": tree}, tokens[:2])
    np.testing.assert_allclose(res[f"{name}/serving_logits"],
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(res[f"{name}/serving_loss"]),
                               float(res[f"{name}/eval_loss_after"]),
                               **LOSS_TOL)


def test_fused_ce_equals_the_naive_vocab_parallel_ce(runs):
    """At pipe 2 x model 2 under 1F1B, the fused vocab-parallel CE and
    the naive one give the same loss and the same updated parameters."""
    ranks, _ = runs
    fused, naive = W.PP_CASES[5][0], W.PP_NAIVE_TWIN[0]
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{naive}/loss"]),
                                   float(res[f"{fused}/loss"]), **LOSS_TOL)
        for k, v in res.items():
            if k.startswith(f"{fused}/local/"):
                np.testing.assert_allclose(
                    res[k.replace(fused, naive)], v, **PARAM_TOL, err_msg=k)


def test_validation_follows_the_jax_package():
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        single_device_mesh,
    )

    mesh = single_device_mesh()
    with pytest.raises(ValueError, match="schedule"):
        tpl.PipelinedLM(mesh, TCFG, 4, schedule="zb", device="cpu")
    with pytest.raises(ValueError, match="virtual_chunks"):
        tpl.PipelinedLM(mesh, TCFG, 4, virtual_chunks=0, device="cpu")
    with pytest.raises(ValueError, match="chunk-stages"):
        tpl.PipelinedLM(mesh, TCFG, 4, virtual_chunks=3, device="cpu")
    with pytest.raises(ValueError, match="pipe >= 2"):
        tpl.PipelinedLM(mesh, TCFG, 4, schedule="1f1b", virtual_chunks=2,
                        device="cpu")
    pp = tpl.PipelinedLM(mesh, TCFG, 4, schedule="auto", device="cpu")
    assert pp.schedule == "gpipe"
    assert pp.ppermute_bytes_per_step(2) == 0.0
    assert pp.pipe_wire_bytes_per_step(2, 16) == 0
    assert pp.layout_metadata() == {
        "format": "pipelined_lm_stages", "n_stages": 1,
        "virtual_chunks": 1, "layers_per_chunk": 4, "tp": 1}


@pytest.mark.parametrize("schedule,remat", [("gpipe", "block"),
                                            ("gpipe", "attention"),
                                            ("1f1b", "attention")])
def test_precision_policy_and_remat_keep_the_step(schedule, remat):
    """``precision=`` goes through ``core/precision.py``'s policies; a
    remat mode is an execution plan: the loss and every gradient equal
    the step without it (one process, pipe 1)."""
    from distributed_tensorflow_guide_tpu_torch.core import precision
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        single_device_mesh,
    )

    full = ttf.Transformer(TCFG).init_weights(0).state_dict()
    batch = {"tokens": W.pp_tokens(1)}
    runs = []
    for policy in ("f32", precision.Policy("f32_remat",
                                           compute_dtype=torch.float32,
                                           remat=remat)):
        pp = tpl.PipelinedLM(single_device_mesh(), TCFG, W.PP_M,
                             schedule=schedule, precision=policy,
                             device="cpu")
        assert pp.cfg.dtype == torch.float32
        runs.append(pp.loss_and_grads(pp.shard_params(full), batch))
    assert pp.cfg.remat_mode == remat
    (l0, g0), (l1, g1) = runs
    assert l1.item() == pytest.approx(l0.item(), rel=1e-6)
    for n, g in g0.items():
        np.testing.assert_allclose(g1[n], g, rtol=1e-5, atol=1e-7,
                                   err_msg=n)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_the_last_chunk_stage_runs_each_block_once(schedule):
    """At pipe 1 the only chunk-stage is the last one: it hands nothing
    on, so 1F1B's forward tick runs nothing and its backward tick runs
    each block once a microbatch, as GPipe does."""
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        single_device_mesh,
    )

    pp = tpl.PipelinedLM(single_device_mesh(), TCFG, W.PP_M,
                         schedule=schedule, fused_ce=False, device="cpu")
    module = pp.init_params(0)
    calls = []
    for chunk in module.chunks:
        for blk in chunk:
            blk.register_forward_hook(lambda *_: calls.append(1))
    pp.loss_and_grads(module, {"tokens": W.pp_tokens(1)})
    assert len(calls) == TCFG.num_layers * W.PP_M
