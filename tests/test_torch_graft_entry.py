"""The port's ``graft_entry`` (``entry()``, ``dryrun_multichip(n)``) held
to the repository root's ``__graft_entry__.py``, and
``collectives.record_event`` to the JAX package's.

* (a) ``entry(device="cpu")``: GPT-2 124M at bf16, its shapes and dtypes,
  and its logits on ``tokens[:1, :64]`` against the reference ``entry()``'s
  on the reference's weights, bridged. Tolerance: 2**-4 absolute. The
  logits reach |x| ~ 2.5, where a bf16 step is 2**-6, and both packages
  round the residual stream to bf16 after each of the 24 sub-layers in
  their own summation orders: four steps at that scale. The argmax must
  agree wherever the reference's top-2 gap exceeds the tolerance.
* (b) One 8-rank gloo world (``tests/torch_mp_workers.py:graft_job``)
  runs ``dryrun_multichip(8, device="cpu")`` inside itself: rank 0's 15
  mode lines are the reference's recorded lines (``MULTICHIP_r05.json``,
  a run at n = 8) in order and format, the losses aside (their weights
  are drawn from other seeds) and finite, without the reference's
  fallback warning (the port runs K4 at any S_local on a card; on the
  CPU its ring takes the blockwise path, as the reference's does), and
  the last line is exact.
* (c) In the same world, modes 1 (GPipe), 5 (tp), 9 (LocalSGD) and 12
  (FSDP) again from the reference's starting weights, built here with
  its own calls and keys and bridged: their losses equal the reference's
  step losses, float32, ``rtol=1e-5``; the shards TP and FSDP cut from
  the bridged weights are ``tp_params_from_flax``'s and
  ``fsdp_params_from_flax``'s, bitwise.
* (d) The inputs every mode draws are the reference's draws, replayed
  here with numpy alone in its order.
* (e) ``record_event`` shows in ``CommTrace.calls`` under ``op[axis]``
  with the reference's payload bytes and sends nothing.
* (f) Without a card and without ``device="cpu"`` both entry points
  raise; a rank that raises ends the world with its traceback, and the
  last line is never printed.
"""

import json
import re
import tempfile

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__ as ref
from distributed_tensorflow_guide_tpu.collectives import (
    collectives as jcc,
)
from distributed_tensorflow_guide_tpu.core.mesh import MeshSpec, build_mesh
from distributed_tensorflow_guide_tpu.models.transformer import (
    Transformer as JTransformer,
)
from distributed_tensorflow_guide_tpu.models.transformer import (
    make_cls_loss_fn,
)
from distributed_tensorflow_guide_tpu.parallel.async_ps import LocalSGD
from distributed_tensorflow_guide_tpu.parallel.fsdp import FSDP
from distributed_tensorflow_guide_tpu.parallel.pipeline import PipelinedLM
from distributed_tensorflow_guide_tpu.parallel.tensor import TensorParallel
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch import graft_entry as G
from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as tcc,
)
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from tests import torch_mp_workers as W

LOGIT_TOL = 2.0 ** -4
LOSS_TOL = dict(rtol=1e-5)
N = 8


# ---- (a) entry() ------------------------------------------------------------


def test_entry_on_the_cpu_matches_the_reference_logits():
    forward, (model, tokens) = G.entry(device="cpu")
    assert model.cfg.dtype == torch.bfloat16 and model.cfg.num_layers == 12
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert tokens.shape == (4, 1024) and tokens.dtype == torch.int64
    assert bool((tokens == 1).all()) and tokens.device.type == "cpu"
    jforward, (variables, jtokens) = ref.entry()
    assert jtokens.shape == tuple(tokens.shape)
    want = np.asarray(jax.jit(jforward)(variables, jtokens[:1, :64]),
                      np.float32)
    tree = jax.tree.map(np.asarray, flax.linen.meta.unbox(
        variables["params"]))
    model.load_state_dict(bridge.params_from_flax(tree, model.cfg))
    with torch.no_grad():
        got = forward(model, tokens[:1, :64])
    assert got.shape == (1, 64, 50304) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    top2 = np.sort(want[0], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > LOGIT_TOL
    assert clear.sum() > 32  # most rows hold a clear winner
    np.testing.assert_array_equal(got[0].argmax(-1)[clear],
                                  want[0].argmax(-1)[clear])


# ---- (b), (c): one 8-rank world and the reference's losses ------------------


def _host(tree) -> dict:
    """A JAX param tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, flax.core.unfreeze(
        flax.linen.meta.unbox(jax.device_get(tree))))


def _jax_reference() -> tuple[dict, dict]:
    """The reference dryrun's modes 1, 5, 9 and 12 at n = 8, with its
    calls and keys (``__graft_entry__.py:101,162,275,302``), on the
    inputs ``G.draw_inputs(8)`` gives: ({mode: its starting weights as a
    numpy tree}, {mode: a call running its step, returning the loss})."""
    devices = jax.devices()[:N]
    inputs = G.draw_inputs(N)
    trees, steps = {}, {}

    mesh = build_mesh(MeshSpec(data=-1, pipe=4), devices=devices)
    pp = PipelinedLM(mesh, ref._tiny_cfg(), num_microbatches=2)
    params = pp.init_params(jax.random.PRNGKey(0))
    trees["gpipe"] = _host(params)

    def gpipe():
        tx = optax.adam(1e-3)
        _, _, m = pp.make_train_step(tx, params, donate=False)(
            pp.init_opt_state(tx, params), params, inputs["tokens"])
        return float(m["loss"])

    mesh_tp = build_mesh(MeshSpec(data=-1, model=4), devices=devices)
    tp = TensorParallel(mesh_tp)
    cfg_tp = ref._tiny_cfg(causal=False, num_classes=2)
    model = JTransformer(cfg_tp)
    p_tp, shardings = tp.init_params(
        model, jax.random.PRNGKey(1), jnp.zeros((1, cfg_tp.max_len),
                                                 jnp.int32))
    trees["tensor_parallel"] = _host(p_tp)

    def tensor_parallel():
        state = train_state.TrainState.create(
            apply_fn=model.apply, params=p_tp, tx=optax.adam(1e-3))
        st_shard = tp.state_shardings(state, shardings)
        step = tp.make_train_step(make_cls_loss_fn(model), st_shard,
                                  donate=False)
        _, m = step(jax.device_put(state, st_shard),
                    {"tokens": inputs["tp_tokens"],
                     "label": inputs["tp_label"]})
        return float(m["loss"])

    class _MLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(1)(fnn.relu(fnn.Dense(16)(x)))

    mlp = _MLP()
    mesh_dp = build_mesh(MeshSpec(data=-1), devices=devices)

    def mlp_loss(params, batch):
        x, y = batch
        return jnp.mean((mlp.apply({"params": params}, x) - y) ** 2), {}

    x_all, y_all = inputs["x_all"], inputs["y_all"]
    p0 = mlp.init(jax.random.PRNGKey(3), jnp.zeros((1, 8)))["params"]
    trees["local_sgd"] = _host(p0)

    def local_sgd():
        local = LocalSGD(mesh_dp, sync_period=2)
        st = local.replicate(train_state.TrainState.create(
            apply_fn=mlp.apply, params=p0, tx=optax.adam(1e-2)))
        _, m = local.make_train_step(mlp_loss, donate=False)(
            st, local.shard_batch((x_all, y_all), leading_time_axis=True))
        return float(m["loss"])

    fsdp = FSDP(mesh_dp, min_shard_size=2 ** 6)
    pf, shardings_f = fsdp.init_params(
        lambda: mlp.init(jax.random.PRNGKey(4), jnp.zeros((1, 8)))["params"])
    trees["fsdp"] = _host(pf)

    def fsdp_step():
        st_f = train_state.TrainState.create(apply_fn=mlp.apply, params=pf,
                                             tx=optax.adam(1e-2))
        st_sh = fsdp.state_shardings(st_f, shardings_f)
        _, m = fsdp.make_train_step(mlp_loss, st_sh, donate=False)(
            jax.device_put(st_f, st_sh),
            jax.device_put((x_all[0], y_all[0]),
                           NamedSharding(mesh_dp, P("data"))))
        return float(m["loss"])

    steps.update(gpipe=gpipe, tensor_parallel=tensor_parallel,
                 local_sgd=local_sgd, fsdp=fsdp_step)
    return trees, steps


@pytest.fixture(scope="module")
def world():
    """(rank 0's stdout, every rank's result, the reference's losses):
    the ranks start from the reference's weights, and the reference's
    steps run while they do."""
    trees, steps = _jax_reference()
    with tempfile.TemporaryDirectory(prefix="dtg_graft_") as tmp:
        for name, tree in trees.items():
            np.savez(f"{tmp}/{name}.npz", **W.flatten(tree))
        runner = mp.MultiProcessRunner("tests.torch_mp_workers:graft_job", N,
                                       [tmp], timeout=300).start()
        try:
            jax_losses = {name: step() for name, step in steps.items()}
        finally:
            results = runner.join()
    return results[0].stdout, [r.result for r in results], jax_losses


def _reference_lines() -> list[str]:
    with open("MULTICHIP_r05.json") as f:
        rec = json.load(f)
    assert rec["n_devices"] == N and rec["ok"]
    return [ln for ln in rec["tail"].splitlines()
            if not ln.startswith("ring_attention impl=")]


def test_dryrun_prints_the_reference_lines_in_order(world):
    stdout, *_ = world
    lines = [ln for ln in stdout.splitlines()
             if not ln.startswith("DTG_MP_RESULT ")]
    want = _reference_lines()
    assert len(want) == 16 and len(lines) == 16, lines
    assert lines[-1] == want[-1] == G.LAST_LINE.format(n=N)
    for got, line in zip(lines[:-1], want[:-1]):
        head, loss, _ = line.partition("loss=")
        if not loss:
            assert got == line
            continue
        assert got.startswith(head + loss), (got, line)
        value = got[len(head + loss):]
        assert re.fullmatch(r"\d+\.\d{3}", value), (got, line)
        assert np.isfinite(float(value))


@pytest.mark.parametrize("mode", W.GRAFT_PARITY_MODES)
def test_mode_loss_matches_the_reference_on_its_weights(world, mode):
    _, ranks, jax_losses = world
    for res in ranks:
        np.testing.assert_allclose(res[f"{mode}/loss"], jax_losses[mode],
                                   **LOSS_TOL, err_msg=f"rank {res['rank']}")


@pytest.mark.parametrize("mode", ["tensor_parallel", "fsdp"])
def test_modes_cut_the_bridges_shards(world, mode):
    _, ranks, *_ = world
    assert all(res[f"{mode}/bridge_shards"] for res in ranks)


# ---- (d) the draws ---------------------------------------------------------


def _reference_draws(n: int) -> list[np.ndarray]:
    """``__graft_entry__.dryrun_multichip``'s numpy draws in its order
    (lines 99-356), replayed with numpy alone."""
    rng = np.random.RandomState(0)
    n_pipe = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    out = [rng.randint(0, 128, (4 * (n // n_pipe), 32)).astype(np.int32)]
    if n % 2 == 0:
        out.append(rng.randint(0, 128, (4 * (n // 2), 32)).astype(np.int32))
    if n % 8 == 0:
        out.append(rng.randint(0, 128, (4 * (n // 4), 32)).astype(np.int32))
    out.append(rng.randint(0, 128, (8, 32)).astype(np.int32))
    out.append(rng.randint(0, 2, 8).astype(np.int32))
    out.append(np.asarray(rng.randn(16 * n, 16), np.float32))
    out.append(rng.randint(0, 128, (2 * n, 16)).astype(np.int32))
    out.append(np.asarray(rng.randn(2, 8 * n_pipe, 4, 16), np.float32))
    x_all = rng.randn(2, 4 * n, 8).astype(np.float32)
    out += [x_all, np.tanh(x_all[..., :1]).astype(np.float32)]
    out.append(np.asarray(rng.randn(2 * n, 128, 2, 8), np.float32))
    out.append(rng.randint(0, 128, (2 * n, 4)).astype(np.int32))
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_inputs_are_the_reference_draws_in_its_order(n):
    got = list(G.draw_inputs(n).values())
    want = _reference_draws(n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---- (e) record_event -------------------------------------------------------


@pytest.mark.parametrize("tree", [None, "arrays"])
def test_record_event_counts_a_call_and_sends_nothing(tree):
    if tree == "arrays":
        tree = {"a": np.zeros((3, 4), np.float32),
                "b": [np.zeros(5, np.int32)]}
        ttree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5,
                                                          dtype=torch.int32)]}
    else:
        ttree = None
    with jcc.trace_comm() as jrec:
        jcc.record_event("blockwise_fallback", "context", tree)
    with tcc.trace_comm() as rec:
        tcc.record_event("blockwise_fallback", "context", ttree)
        tcc.record_event("fallback", ("data", "expert"))
    key = "blockwise_fallback[context]"
    assert dict(rec.calls) == {key: 1, "fallback[data,expert]": 1}
    assert dict(jrec.calls) == {key: 1}
    assert rec.bytes[key] == jrec.bytes[key]
    assert sum(rec.wire.values()) == 0.0
    tcc.record_event("outside", "data")  # no active trace: nothing


# ---- (f) the failure paths --------------------------------------------------


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.dryrun_multichip(2)


def test_a_failing_rank_ends_the_world_with_its_traceback(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(G, "RANK_TARGET",
                        "tests.torch_mp_workers:graft_failing_rank")
    with pytest.raises(RuntimeError) as err:
        G.dryrun_multichip(2, device="cpu")
    assert "rank 1" in str(err.value) and "boom on rank 1" in str(err.value)
    out = capsys.readouterr().out
    assert out.startswith("dp(1)xpp(2) pipeline step: loss=")
    assert G.LAST_LINE.format(n=2) not in out
