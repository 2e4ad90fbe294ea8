"""The port's k-step train step (``steps_per_call``), device prefetch
(``data/prefetch.py``) and the loop's fan-out, held to the JAX package on
the CPU.

* ``data/prefetch.py``: the pins of ``tests/test_prefetch.py:45-234``:
  order and termination, depth validated, the buffer running ``depth``
  ahead, a consumer that writes into its batch disturbing no later batch,
  ``pack_batches``' layout, ``pack_stream``'s remainder;
* ``DataParallel`` (``tests/test_data_parallel.py:156,189``), its stats
  step, ``TensorParallel`` (``tests/test_pipeline.py:649``) and
  ``PipelinedLM`` (``tests/test_pipeline.py:528,563``): the port's k-step
  call from bridged weights against the reference's ``steps_per_call``
  call, stacked and repeated, every per-step loss and the parameters
  after the call within f32 1e-5 (absolute; the losses also 1e-5
  relative); and the k-step call against k one-step calls of the port,
  bitwise (the CPU runs the k steps eagerly, the same kernels in the same
  order); the reference's validation and messages;
* ``TrainLoop(steps_per_call=k)``: the loop against single steps (every
  step observed by the hooks in order, n / k calls), the stop at the call
  boundary, tail stragglers through ``tail_step_fn`` or dropped with the
  reference's warning, last-step-only metrics refused;
* ``core/graphs.MultiStep``'s refusals, which guard the captured step on
  the card: another state, another batch shape or dtype, a float
  learning rate moved between calls, an lr schedule at k > 1, an
  optimizer without ``capturable=True``.
"""

import functools
import logging

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state
from jax.sharding import Mesh

from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.parallel import pipeline as jpl
from distributed_tensorflow_guide_tpu.parallel.data_parallel import (
    DataParallel as JDataParallel,
)
from distributed_tensorflow_guide_tpu.parallel.tensor import (
    TensorParallel as JTensorParallel,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core import graphs
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.data.prefetch import (
    DevicePrefetchIterator,
    pack_batches,
    pack_stream,
    prefetch_to_device,
)
from distributed_tensorflow_guide_tpu_torch.models import resnet
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel import pipeline as tpl
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
    TensorParallel,
)
from distributed_tensorflow_guide_tpu_torch.train.hooks import (
    BaseHook,
    StopAtStepHook,
)
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from tests import torch_mp_workers as W

GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=16, d_ff=32,
            max_len=16, causal=True)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
K = 3
LR = 1e-3
TOL = dict(rtol=0, atol=1e-5)


def _host_batches(n, rows=16, seed=0):
    r = np.random.RandomState(seed)
    return [{"x": r.randn(rows, 3).astype(np.float32),
             "y": r.randn(rows).astype(np.float32)} for _ in range(n)]


def _tokens(n, seed):
    return [{"tokens": np.random.RandomState(seed + i).randint(
        0, 64, (4, GEOM["max_len"])).astype(np.int64)} for i in range(n)]


# ---- prefetch ------------------------------------------------------------------


def test_prefetch_ordering_and_stopiteration():
    batches = [{"x": np.full((4,), i, np.float32)} for i in range(7)]
    it = DevicePrefetchIterator(batches, depth=3, device="cpu")
    seen = [float(b["x"][0]) for b in it]
    assert seen == list(range(7))
    with pytest.raises(StopIteration):
        next(it)
    assert it.stats.batches == 7
    assert it.stats.peak_ahead == 3  # the buffer ran ahead
    d = it.stats.as_dict()
    assert d["prefetch_batches"] == 7 and d["prefetch_peak_ahead"] == 3
    assert d["prefetch_max_host_wait_s"] >= 0


@pytest.mark.parametrize("depth", [0, -1])
def test_prefetch_depth_validated(depth):
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetchIterator([], depth=depth, device="cpu")


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetchIterator([])


def test_prefetch_yields_tensors_on_the_device_and_nested_trees():
    src = [{"a": np.arange(4), "b": (np.ones(2), [np.zeros(3)])}
           for _ in range(3)]
    out = list(prefetch_to_device(src, device="cpu"))
    assert len(out) == 3
    b = out[0]
    assert isinstance(b["a"], torch.Tensor) and b["a"].device.type == "cpu"
    assert isinstance(b["b"], tuple) and isinstance(b["b"][1], list)
    assert b["b"][1][0].shape == (3,)


def test_prefetch_consumer_may_write_into_its_batch():
    """A consumer that writes into each batch it gets (what a donating
    step does with its buffers) must see every later batch intact: each
    batch is its own allocation and the iterator keeps no reference to a
    yielded one."""
    dp = DataParallel(device="cpu")
    batches = _host_batches(6, seed=3)
    expected = [float(np.sum(b["x"]) + np.sum(b["y"])) for b in batches]
    got = []
    for b in dp.prefetch(iter(batches), depth=3):
        got.append(float(b["x"].sum() + b["y"].sum()))
        b["x"].mul_(2.0)
        b["y"].zero_()
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_pack_batches_layout():
    packed = pack_batches(_host_batches(4, rows=8))
    assert packed["x"].shape == (4, 8, 3) and packed["y"].shape == (4, 8)
    assert isinstance(packed["x"], np.ndarray)
    torch_packed = pack_batches([{"t": torch.ones(2)}, {"t": torch.zeros(2)}])
    assert torch.equal(torch_packed["t"], torch.tensor([[1., 1.], [0., 0.]]))
    with pytest.raises(ValueError, match="at least one"):
        pack_batches([])


def test_pack_stream_drop_remainder():
    full = list(pack_stream(_host_batches(7), 3))
    assert len(full) == 2 and all(p["x"].shape[0] == 3 for p in full)
    kept = list(pack_stream(_host_batches(7), 3, drop_remainder=False))
    assert [p["x"].shape[0] for p in kept] == [3, 3, 1]
    with pytest.raises(ValueError, match="steps_per_call"):
        list(pack_stream(_host_batches(2), 0))


# ---- DataParallel against the reference ------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _tmodel(jparams, cfg=TCFG):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    m = ttf.Transformer(cfg)
    m.load_state_dict(bridge.params_from_flax(tree, cfg))
    return m


def _jdp_run(jparams, batches, k, stacked):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    dp = JDataParallel(mesh)
    model = jtf.Transformer(JCFG)
    state = dp.replicate(train_state.TrainState.create(
        apply_fn=model.apply, params=jparams, tx=optax.adam(LR)))
    step = dp.make_train_step(jtf.make_lm_loss_fn(model, fused_ce=False),
                              donate=False, steps_per_call=k,
                              stacked_batch=stacked, per_step_metrics=True)
    b = pack_batches(batches) if stacked else batches[0]
    state, m = step(state, jax.tree.map(
        lambda x: jnp.asarray(x.astype(np.int32)), b))
    return (np.asarray(m["loss"]), bridge.params_from_flax(
        jax.tree.map(np.asarray, fnn.meta.unbox(jax.device_get(
            state.params))), TCFG))


def _tdp(model, **kw):
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    step = DataParallel(device="cpu").make_train_step(
        ttf.make_lm_loss_fn(model, fused_ce=False), **kw)
    return state, step


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "repeat"])
def test_dp_k_steps_match_the_reference(jparams, stacked):
    batches = _tokens(K, seed=1)
    want_losses, want_sd = _jdp_run(jparams, batches, K, stacked)
    state, step = _tdp(_tmodel(jparams), steps_per_call=K,
                       stacked_batch=stacked, per_step_metrics=True)
    b = pack_batches(batches) if stacked else batches[0]
    state, m = step(state, b)
    assert step.captured is False and state.step == K
    assert m["loss"].shape == (K,)
    np.testing.assert_allclose(m["loss"].numpy(), want_losses, rtol=1e-5,
                               atol=TOL["atol"])
    for n, t in state.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want_sd[n].numpy(), **TOL,
                                   err_msg=n)


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "repeat"])
def test_dp_k_steps_are_bitwise_k_single_steps(jparams, stacked):
    batches = _tokens(K, seed=2)
    s1, one = _tdp(_tmodel(jparams))
    losses = []
    for j in range(K):
        s1, m = one(s1, batches[j] if stacked else batches[0])
        losses.append(m["loss"])
    sk, multi = _tdp(_tmodel(jparams), steps_per_call=K,
                     stacked_batch=stacked)
    sk, mk = multi(sk, pack_batches(batches) if stacked else batches[0])
    assert torch.equal(mk["loss"], losses[-1])  # the last inner step's
    for a, b in zip(s1.model.parameters(), sk.model.parameters()):
        assert torch.equal(a, b)
    _, eager = _tdp(_tmodel(jparams), steps_per_call=K,
                    stacked_batch=stacked, per_step_metrics=True)
    _, me = eager.eager(TrainState(
        eager_model := _tmodel(jparams),
        torch.optim.Adam(eager_model.parameters(), lr=LR)),
        pack_batches(batches) if stacked else batches[0])
    assert torch.equal(me["loss"], torch.stack(losses))


def test_dp_steps_per_call_one_keeps_the_one_step_metrics(jparams):
    state, step = _tdp(_tmodel(jparams), steps_per_call=1,
                       per_step_metrics=True)
    _, m = step(state, _tokens(1, seed=3)[0])
    assert m["loss"].shape == ()


def test_dp_steps_per_call_validation(jparams):
    loss_fn = ttf.make_lm_loss_fn(ttf.Transformer(TCFG), fused_ce=False)
    dp = DataParallel(device="cpu")
    with pytest.raises(ValueError, match="steps_per_call"):
        dp.make_train_step(loss_fn, steps_per_call=0)
    for kw in ({}, {"steps_per_call": 1}):
        with pytest.raises(ValueError, match="stacked_batch"):
            dp.make_train_step(loss_fn, stacked_batch=True, **kw)
    state, step = _tdp(_tmodel(jparams), steps_per_call=2,
                       stacked_batch=True)
    with pytest.raises(ValueError, match="leading axis"):
        step(state, pack_batches(_tokens(3, seed=0)))


def test_stats_step_k_steps_are_bitwise_single_steps():
    """make_train_step_with_stats: k steps a call over a stacked batch
    leave the parameters and the running statistics of k single calls."""
    batch = W.stats_batch()
    packs = [{k: v[4 * i:4 * (i + 1)] for k, v in batch.items()}
             for i in range(2)]
    states = []
    for k in (None, 2):
        model = W.stats_model()
        state = TrainState(model, torch.optim.SGD(
            model.parameters(), lr=W.STATS_LR, momentum=0.9))
        step = DataParallel(device="cpu").make_train_step_with_stats(
            resnet.make_loss_fn(model), steps_per_call=k,
            stacked_batch=k is not None, per_step_metrics=k is not None)
        if k is None:
            for p in packs:
                step(state, p)
        else:
            _, m = step(state, pack_batches(packs))
            assert m["loss"].shape == (2,)
        states.append(model.state_dict())
    for n in states[0]:
        assert torch.equal(states[0][n], states[1][n]), n


# ---- TensorParallel and PipelinedLM against the reference ------------------------

TP_GEOM = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
               max_len=16, causal=False, num_classes=2)


def _cls_batch(seed):
    r = np.random.RandomState(seed)
    t = r.randint(0, 64, (8, TP_GEOM["max_len"])).astype(np.int64)
    return {"tokens": t, "label": (t[:, 0] % 2).astype(np.int64)}


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "repeat"])
def test_tp_k_steps_match_the_reference(stacked):
    """tests/test_pipeline.py:649 on the port, one rank of a (1, 1)
    mesh: the reference's TensorParallel k-step call from the same
    weights."""
    jcfg = jtf.TransformerConfig(**TP_GEOM, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**TP_GEOM, dtype=torch.float32)
    batches = [_cls_batch(s) for s in range(K)]
    b = pack_batches(batches) if stacked else batches[0]

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    jtp = JTensorParallel(mesh)
    jmodel = jtf.Transformer(jcfg)
    params, shardings = jtp.init_params(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, jcfg.max_len),
                                                 jnp.int32))
    host = jax.tree.map(np.asarray, jax.device_get(params))
    st = train_state.TrainState.create(apply_fn=jmodel.apply, params=params,
                                       tx=optax.adam(LR))
    sh = jtp.state_shardings(st, shardings)
    jstep = jtp.make_train_step(jtf.make_cls_loss_fn(jmodel), sh,
                                donate=False, steps_per_call=K,
                                stacked_batch=stacked)
    st, jm = jstep(jax.device_put(st, sh), jax.tree.map(
        lambda x: x.astype(np.int32), b))
    want = bridge.params_from_flax(
        jax.tree.map(np.asarray, jax.device_get(st.params)), tcfg)

    tp = TensorParallel(single_device_mesh(), device="cpu")
    full = ttf.Transformer(tcfg)
    full.load_state_dict(bridge.params_from_flax(host, tcfg))
    local = tp.shard(full)
    state = TrainState(local, torch.optim.Adam(local.parameters(), lr=LR))
    step = tp.make_train_step(ttf.make_cls_loss_fn(local), steps_per_call=K,
                              stacked_batch=stacked)
    state, m = step(state, b)
    assert m["loss"].shape == ()  # the last inner step's, as the reference
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    for n, t in state.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), **TOL,
                                   err_msg=n)


def _pp_tokens(n, seed):
    return [np.random.RandomState(seed + i).randint(
        0, 64, (W.PP_M * W.PP_MB, W.PP_GEOM["max_len"])).astype(np.int64)
        for i in range(n)]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "repeat"])
def test_pipeline_k_steps_match_the_reference(schedule, stacked):
    """tests/test_pipeline.py:528 on the port at pipe 1: the reference's
    PipelinedLM k-step call (Adam) from the same weights; and the port's
    k-step call bitwise its k one-step calls."""
    tcfg = ttf.TransformerConfig(**W.PP_GEOM, dtype=torch.float32)
    jcfg = jtf.TransformerConfig(**W.PP_GEOM, dtype=jnp.float32)
    full = ttf.Transformer(tcfg).init_weights(0).state_dict()
    toks = _pp_tokens(K, seed=5)
    tokens = np.stack(toks) if stacked else toks[0]

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                ("data", "pipe", "model"))
    jpp = jpl.PipelinedLM(mesh, jcfg, num_microbatches=W.PP_M,
                          schedule=schedule)
    params = jax.device_put(
        jax.tree.map(jnp.asarray,
                     bridge.pipeline_params_to_flax(full, tcfg, 1, 1)),
        jpp.param_shardings())
    tx = optax.adam(LR)
    jstep = jpp.make_train_step(tx, params, donate=False, steps_per_call=K,
                                stacked_batch=stacked)
    _, params, jm = jstep(jpp.init_opt_state(tx, params), params,
                          tokens.astype(np.int32))
    want = bridge.params_from_flax(jax.tree.map(
        np.asarray, jpp.to_serving_params(jax.device_get(params))), tcfg)

    def run(k):
        pp = tpl.PipelinedLM(single_device_mesh(), tcfg, W.PP_M,
                             schedule=schedule, device="cpu")
        module = pp.shard_params(full)
        opt = pp.init_opt_state(functools.partial(torch.optim.Adam, lr=LR),
                                module)
        step = pp.make_train_step(opt, steps_per_call=k,
                                  stacked_batch=stacked and k is not None)
        if k is None:
            for j in range(K):
                module, m = step(module, {"tokens": toks[j] if stacked
                                          else toks[0]})
        else:
            assert step.captured is False
            module, m = step(module, {"tokens": tokens})
        return pp.to_serving_params(module), m["loss"]

    sd_k, loss_k = run(K)
    assert loss_k.item() == pytest.approx(float(jm["loss"]), rel=1e-5)
    for n, t in sd_k.items():
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), **TOL,
                                   err_msg=n)
    sd_1, loss_1 = run(None)
    assert torch.equal(loss_1, loss_k)
    for n in sd_1:
        assert torch.equal(sd_1[n], sd_k[n]), n


def test_pipeline_steps_per_call_validation():
    """tests/test_pipeline.py:563: the reference's refusals."""
    tcfg = ttf.TransformerConfig(**W.PP_GEOM, dtype=torch.float32)
    pp = tpl.PipelinedLM(single_device_mesh(), tcfg, 2, device="cpu")
    module = pp.init_params(0)
    opt = torch.optim.SGD(module.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="steps_per_call"):
        pp.make_train_step(opt, steps_per_call=0)
    with pytest.raises(ValueError, match="stacked_batch"):
        pp.make_train_step(opt, stacked_batch=True)
    step = pp.make_train_step(opt, steps_per_call=2, stacked_batch=True)
    bad = np.stack(_pp_tokens(3, seed=0))[:, :4]  # leading axis 3 != 2
    with pytest.raises(ValueError, match="leading axis"):
        step(module, {"tokens": bad})


# ---- the loop's fan-out ------------------------------------------------------------


class _RecordingHook(BaseHook):
    def __init__(self):
        self.steps: list[int] = []
        self.losses: list[float] = []

    def after_step(self, step, metrics):
        self.steps.append(step)
        self.losses.append(float(metrics["loss"]))


def _linear_setup(lr=0.1):
    model = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=lr))

    def loss_fn(module, batch):
        return ((module(batch["x"])[:, 0] - batch["y"]) ** 2).mean(), {}

    return loss_fn, state


def test_trainloop_steps_per_call_matches_single_steps():
    k, n = 4, 8
    dp = DataParallel(device="cpu")
    batches = _host_batches(n, seed=7)
    loss_fn, state_a = _linear_setup()
    _, state_b = _linear_setup()
    h_a = _RecordingHook()
    loop_a = TrainLoop(dp.make_train_step(loss_fn), state_a, batches,
                       hooks=[h_a], device="cpu")
    loop_a.run()
    multi = dp.make_train_step(loss_fn, steps_per_call=k,
                               stacked_batch=True, per_step_metrics=True)
    h_b = _RecordingHook()
    loop_b = TrainLoop(multi, state_b, dp.prefetch(iter(batches),
                                                   steps_per_call=k),
                       hooks=[h_b], steps_per_call=k, device="cpu")
    loop_b.run()
    assert h_b.steps == h_a.steps == list(range(n))
    assert h_b.losses == h_a.losses
    assert torch.equal(state_a.model.weight, state_b.model.weight)
    assert loop_a.dispatch_stats.dispatches == n
    assert loop_b.dispatch_stats.dispatches == n // k
    assert loop_b.dispatch_stats.steps == n
    assert loop_b.dispatch_stats.as_dict()["opt_steps"] == n


def test_trainloop_stop_at_dispatch_boundary():
    k = 2
    dp = DataParallel(device="cpu")
    loss_fn, state = _linear_setup()
    multi = dp.make_train_step(loss_fn, steps_per_call=k,
                               stacked_batch=True, per_step_metrics=True)
    loop = TrainLoop(multi, state, dp.prefetch(iter(_host_batches(20)),
                                               steps_per_call=k),
                     hooks=[StopAtStepHook(6)], steps_per_call=k,
                     device="cpu")
    loop.run()
    assert loop.step == 6 and loop.dispatch_stats.dispatches == 3
    # a stop between boundaries overshoots to the end of the call
    _, state = _linear_setup()
    multi4 = dp.make_train_step(loss_fn, steps_per_call=4,
                                stacked_batch=True, per_step_metrics=True)
    loop = TrainLoop(multi4, state, dp.prefetch(iter(_host_batches(20)),
                                                steps_per_call=4),
                     hooks=[StopAtStepHook(5)], steps_per_call=4,
                     device="cpu")
    loop.run()
    assert loop.step == 8 and loop.dispatch_stats.dispatches == 2


def test_trainloop_tail_runs_stragglers():
    k, n = 4, 6
    dp = DataParallel(device="cpu")
    batches = _host_batches(n, seed=11)
    loss_fn, state_a = _linear_setup()
    _, state_b = _linear_setup()
    one = dp.make_train_step(loss_fn)
    TrainLoop(one, state_a, batches, device="cpu").run()
    multi = dp.make_train_step(loss_fn, steps_per_call=k,
                               stacked_batch=True, per_step_metrics=True)
    h = _RecordingHook()
    loop_b = TrainLoop(
        multi, state_b,
        dp.prefetch(iter(batches), steps_per_call=k, drop_remainder=False),
        hooks=[h], steps_per_call=k, tail_step_fn=one, device="cpu")
    loop_b.run()
    assert loop_b.step == n and h.steps == list(range(n))
    assert loop_b.dispatch_stats.dispatches == 1 + (n - k)
    assert torch.equal(state_a.model.weight, state_b.model.weight)


def test_trainloop_drops_a_tail_without_tail_step_fn(caplog):
    k = 4
    dp = DataParallel(device="cpu")
    loss_fn, state = _linear_setup()
    multi = dp.make_train_step(loss_fn, steps_per_call=k,
                               stacked_batch=True, per_step_metrics=True)
    loop = TrainLoop(multi, state, dp.prefetch(
        iter(_host_batches(6)), steps_per_call=k, drop_remainder=False),
        steps_per_call=k, device="cpu")
    with caplog.at_level(logging.WARNING, logger="dtg.train"):
        loop.run()
    assert loop.step == k
    assert "dropping a tail pack of 2 < steps_per_call=4" in caplog.text


def test_trainloop_rejects_last_step_only_metrics():
    k = 2
    dp = DataParallel(device="cpu")
    loss_fn, state = _linear_setup()
    multi = dp.make_train_step(loss_fn, steps_per_call=k,
                               stacked_batch=True)  # last-step metrics only
    loop = TrainLoop(multi, state, dp.prefetch(iter(_host_batches(k)),
                                               steps_per_call=k),
                     steps_per_call=k, device="cpu")
    with pytest.raises(ValueError, match="per_step_metrics"):
        loop.run()
    with pytest.raises(ValueError, match="steps_per_call"):
        TrainLoop(multi, state, [], steps_per_call=0, device="cpu")


# ---- MultiStep's refusals (the captured step's guards) -------------------------


def _bound_multi(k=2, lr=0.1, capturable=None):
    """A MultiStep marked captured, bound to a state as its first call
    would bind it (the card is not needed to check the guards)."""
    model = torch.nn.Linear(3, 1, bias=False)
    opt = (torch.optim.Adam(model.parameters(), lr=lr,
                            capturable=capturable)
           if capturable is not None
           else torch.optim.SGD(model.parameters(), lr=lr))
    state = TrainState(model, opt)
    ms = graphs.MultiStep(lambda st, b: (st, {}), steps_per_call=k,
                          stacked_batch=False, per_step_metrics=False,
                          capture=True, device="cpu")
    batch = {"x": torch.zeros(4, 3)}
    ms._bind(state, opt, batch)
    return ms, state, batch


def test_captured_step_refuses_another_state_or_batch():
    ms, state, batch = _bound_multi()
    ms._check_bound(state, state.optimizer, batch)
    _, other, _ = _bound_multi()
    with pytest.raises(ValueError, match="first call"):
        ms._check_bound(other, other.optimizer, batch)
    for bad in ({"x": torch.zeros(5, 3)},
                {"x": torch.zeros(4, 3, dtype=torch.float64)}):
        with pytest.raises(ValueError, match="shapes and dtypes"):
            ms._check_bound(state, state.optimizer, bad)


def test_captured_step_refuses_a_float_lr_moved_between_calls():
    ms, state, batch = _bound_multi(k=1)
    state.optimizer.param_groups[0]["lr"] = 0.05
    with pytest.raises(ValueError, match="torch.tensor"):
        ms._check_bound(state, state.optimizer, batch)


def test_captured_step_follows_a_device_lr_at_k1_refuses_it_at_k2():
    for k in (1, 2):
        ms, state, batch = _bound_multi(k=k, lr=torch.tensor(0.1))
        state.optimizer.param_groups[0]["lr"].fill_(0.05)  # a schedule
        if k == 1:
            ms._check_bound(state, state.optimizer, batch)
        else:
            with pytest.raises(ValueError, match="schedule"):
                ms._check_bound(state, state.optimizer, batch)


def test_captured_step_needs_a_capturable_optimizer():
    _, state, _ = _bound_multi(capturable=False)
    with pytest.raises(ValueError, match="capturable=True"):
        graphs.check_capturable(state.optimizer)
    graphs.check_capturable(torch.optim.SGD(
        torch.nn.Linear(2, 2).parameters(), lr=0.1))
    graphs.check_capturable(None)


def test_multistep_validation():
    for kw, match in ((dict(steps_per_call=0, stacked_batch=False),
                       "steps_per_call"),
                      (dict(steps_per_call=1, stacked_batch=True),
                       "stacked_batch")):
        with pytest.raises(ValueError, match=match):
            graphs.MultiStep(lambda s, b: (s, {}), per_step_metrics=False,
                             capture=False, device="cpu", **kw)
    ms = graphs.MultiStep(lambda s, b: (s, {"m": torch.tensor(1.0)}),
                          steps_per_call=3, stacked_batch=False,
                          per_step_metrics=True, capture=False,
                          device="cpu")
    assert ms.captures == 0 and ms.captured is False
    _, m = ms(None, {"x": torch.zeros(2)})
    assert m["m"].shape == (3,)
