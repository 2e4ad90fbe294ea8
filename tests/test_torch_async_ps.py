"""The port's async-PS family (``parallel/async_ps.py``,
``parallel/ps_emulator.py``) held to the JAX package's.

* One 4-rank gloo job (``tests/torch_mp_workers.py:async_ps_job``) runs
  the device cases of tests/test_async_ps.py on tests/test_async_ps.py's
  least-squares problem over a data axis of 4 (the JAX tests use 8
  devices): LocalSGD(K=1) against sync DP, LocalSGD(K=4) learning and
  syncing once a call, GossipSGD contracting the replicas' disagreement
  and learning, AccumulatedAdaptive against one large-batch Adam step.
  Then, over a data axis of 2, LocalSGD(K=2) and AccumulatedAdaptive(K=4)
  with Adam against the JAX strategies on 2 of the conftest's fake
  devices, from the same weights and batches.
* The emulator's cases run here, on the CPU, and its loss sequence in
  each mode equals the JAX emulator's for the same seed, weights and
  batches.
* The bridge's Gossip replicas round trip is bitwise.

Tolerances: tests/test_async_ps.py's, float32: LocalSGD(K=1) against DP
and the emulator against plain SGD ``rtol=1e-5``; AccumulatedAdaptive
against large-batch Adam ``rtol=1e-4, atol=1e-6``. Against JAX: losses
``rtol=1e-5``, parameters ``rtol=1e-4, atol=1e-6`` (torch's Adam and
optax's round the same algebra in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state
from jax.sharding import Mesh

from distributed_tensorflow_guide_tpu.core.mesh import MeshSpec as JMeshSpec
from distributed_tensorflow_guide_tpu.core.mesh import build_mesh as jbuild
from distributed_tensorflow_guide_tpu.models import mnist_cnn as jmnist
from distributed_tensorflow_guide_tpu.parallel import async_ps as jps
from distributed_tensorflow_guide_tpu.parallel.ps_emulator import (
    AsyncPSEmulator as JEmulator,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.parallel import async_ps
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.parallel.ps_emulator import (
    AsyncPSEmulator,
)
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from tests import torch_mp_workers as W

LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
DIM = W.PS_DIM


@pytest.fixture(scope="module")
def job():
    """Each rank's results, with the JAX runs made while the ranks run."""
    runner = mp.MultiProcessRunner("tests.torch_mp_workers:async_ps_job", 4,
                                   timeout=300).start()
    try:
        jax_runs = {"ls2": _jax_run("ls2"), "aa2": _jax_run("aa2")}
    finally:
        ranks = [r.result for r in runner.join()]
    return ranks, jax_runs


def _jloss(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}


def _jax_run(tag):
    """LocalSGD(K=2) for 3 calls or AccumulatedAdaptive(K=4) for 2, Adam
    0.01, on 2 fake devices: the losses and the final ``w``."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    strat, k, calls = ((jps.LocalSGD(mesh, sync_period=2), 2, 3)
                       if tag == "ls2" else
                       (jps.AccumulatedAdaptive(mesh, accum_steps=4), 4, 2))
    state = strat.replicate(train_state.TrainState.create(
        apply_fn=None, params={"w": jnp.asarray(W.ps_w0())},
        tx=optax.adam(0.01)))
    step = strat.make_train_step(_jloss, donate=False)
    losses = []
    for c in range(calls):
        sb = W.ps_superbatch(*W.ps_problem(seed=c), k, 32)
        state, m = step(state, strat.shard_batch(sb, leading_time_axis=True))
        losses.append(float(m["loss"]))
    return losses, np.asarray(state.params["w"])


# ---- LocalSGD (DOWNPOUR) ---------------------------------------------------------


def test_local_sgd_period1_equals_sync_dp(job):
    ranks, _ = job
    for r in ranks:
        np.testing.assert_allclose(r["ls1/w"], r["dp/w"], **LOSS_TOL)


def test_local_sgd_learns_and_syncs(job):
    ranks, _ = job
    for r in ranks:
        res = r["ls4-sgd"]
        assert res["losses"][-1] < res["losses"][0] * 0.1, res["losses"]
        assert res["step"] == 40  # counts local steps


@pytest.mark.parametrize("opt,calls", [("sgd", 2), ("adam", 3)])
def test_local_sgd_comm_every_k_steps(job, opt, calls):
    """One parameter pmean (and one of the float moments: Adam's two,
    never its step count; plain SGD has none) and the loss's, per call of
    K=4 local steps: not K gradient all-reduces."""
    ranks, _ = job
    for r in ranks:
        tr = r[f"ls4-{opt}"]["trace"]
        assert set(tr) == {"pmean[data]"}
        assert tr["pmean[data]"]["calls"] == calls
        moments = 2 * DIM * 4 if opt == "adam" else 0
        assert tr["pmean[data]"]["bytes"] == DIM * 4 + moments + 4


def test_local_sgd_k2_matches_jax(job):
    ranks, jax_runs = job
    want_losses, want_w = jax_runs["ls2"]
    for r in ranks:
        np.testing.assert_allclose(r["ls2/losses"], want_losses, **LOSS_TOL)
        np.testing.assert_allclose(r["ls2/w"], want_w, **PARAM_TOL)


# ---- GossipSGD (Hogwild) -------------------------------------------------------------


def test_gossip_zero_lr_contracts_disagreement(job):
    """At lr 0 only the mixing moves the replicas: a 4-ring at mix 0.5
    contracts their spread by 0.5 a step (the mixing matrix's second
    eigenvalue); 15 steps take it far below a fifth."""
    ranks, _ = job
    before = np.stack([r["gossip0/w_before"] for r in ranks])
    after = np.stack([r["gossip0/w_after"] for r in ranks])
    spread0 = float(np.ptp(before, axis=0).max())
    spread1 = float(np.ptp(after, axis=0).max())
    assert spread1 < spread0 * 0.2, (spread0, spread1)
    # mixing preserves the replicas' mean
    np.testing.assert_allclose(after.mean(0), before.mean(0), atol=1e-5)
    tr = ranks[0]["gossip0/trace"]
    assert tr["ppermute[data]"]["calls"] == 2  # one hop each way
    assert tr["pmean[data]"]["calls"] == 1  # the loss


def test_gossip_learns_and_the_consensus_is_the_mean(job):
    ranks, _ = job
    for r in ranks:
        assert r["gossip/losses"][-1] < r["gossip/losses"][0] * 0.1
    ws = np.stack([r["gossip/w"] for r in ranks])
    assert np.ptp(ws, axis=0).max() > 0  # the replicas disagree ...
    for r in ranks:  # ... and agree on their consensus
        np.testing.assert_array_equal(r["gossip/consensus"],
                                      ranks[0]["gossip/consensus"])
        assert r["gossip/consensus"].shape == (DIM, 1)
    np.testing.assert_allclose(ranks[0]["gossip/consensus"], ws.mean(0),
                               rtol=1e-6, atol=1e-7)


def test_gossip_distribute_is_the_identity():
    gs = async_ps.GossipSGD(single_device_mesh(), device="cpu")
    state = object()
    assert gs.distribute(state) is state


# ---- AccumulatedAdaptive (ADAG) ----------------------------------------------------


def test_adag_equals_large_batch_adam(job):
    """K sub-batch gradients accumulated, one pmean, one Adam step ==
    one Adam step on the concatenated batch."""
    ranks, _ = job
    x, y = W.ps_problem()
    sb = W.ps_superbatch(x, y, 4, 64)
    model = W.ps_model()
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    big = {"x": sb["x"].reshape(-1, DIM), "y": sb["y"].reshape(-1, 1)}
    _, g = value_and_grad(W.ps_loss, model, big)
    model.w.grad = g["w"]
    opt.step()
    for r in ranks:
        np.testing.assert_allclose(r["adag/w"], model.w.detach().numpy(),
                                   **PARAM_TOL)
        assert r["adag/trace"]["pmean[data]"]["calls"] == 2


def test_accumulated_adaptive_matches_jax(job):
    ranks, jax_runs = job
    want_losses, want_w = jax_runs["aa2"]
    for r in ranks:
        np.testing.assert_allclose(r["aa2/losses"], want_losses, **LOSS_TOL)
        np.testing.assert_allclose(r["aa2/w"], want_w, **PARAM_TOL)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        return
    for make in (lambda: async_ps.LocalSGD(single_device_mesh(), 2),
                 lambda: async_ps.GossipSGD(single_device_mesh()),
                 lambda: async_ps.AccumulatedAdaptive(single_device_mesh(),
                                                      2),
                 lambda: AsyncPSEmulator(W.ps_loss, W.ps_model(),
                                         n_workers=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# ---- the host emulator ----------------------------------------------------------------


def _data_iter(x, y, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.randint(0, len(x), batch)
        yield {"x": x[idx], "y": y[idx]}


def _emulator(mode, n_workers, fetch=1, seed=0, lr=0.05):
    return AsyncPSEmulator(W.ps_loss, W.ps_model(np.zeros((DIM, 1),
                                                          np.float32)),
                           n_workers=n_workers, mode=mode, lr=lr,
                           fetch_period=fetch, seed=seed, device="cpu")


def test_hogwild_one_worker_is_plain_sgd():
    x, y = W.ps_problem()
    em = _emulator("hogwild", 1)
    em.run(_data_iter(x, y, seed=1), 20)
    p = W.ps_model(np.zeros((DIM, 1), np.float32))
    it = _data_iter(x, y, seed=1)
    for _ in range(20):
        _, g = value_and_grad(W.ps_loss, p, next(it))
        with torch.no_grad():
            p.w -= 0.05 * g["w"]
    np.testing.assert_allclose(em.ps_params["w"].numpy(),
                               p.w.detach().numpy(), **LOSS_TOL)


@pytest.mark.parametrize("mode,fetch", [("hogwild", 1), ("downpour", 4),
                                        ("adag", 4)])
def test_async_emulation_learns(mode, fetch):
    x, y = W.ps_problem()
    em = _emulator(mode, 4, fetch, seed=2)
    losses = em.run(_data_iter(x, y, seed=3), 200)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.2, (
        mode, losses[:3], losses[-3:])


def test_hogwild_reads_are_fresh():
    """A Hogwild worker reads the PS's current parameters: its first event
    after another worker's ten continues from them."""
    x, y = W.ps_problem()
    em = _emulator("hogwild", 2)
    it = _data_iter(x, y, seed=9)
    for _ in range(10):
        em._event(0, next(it))  # only worker 0 runs
    probe = W.ps_model(np.zeros((DIM, 1), np.float32))

    def loss_at(params, batch):
        with torch.no_grad():
            probe.w.copy_(params["w"])
        (loss, _), g = value_and_grad(W.ps_loss, probe, batch)
        return loss.item(), g["w"]

    loss_before, _ = loss_at(em.ps_params, next(it))
    em._event(1, next(it))
    loss_after, _ = loss_at(em.ps_params, next(it))
    assert loss_after < loss_before * 1.5
    b = next(it)
    g_fresh = loss_at(em.ps_params, b)[1]
    g_stale = loss_at({"w": torch.zeros(DIM, 1)}, b)[1]
    assert not np.allclose(g_fresh.numpy(), g_stale.numpy())


def test_downpour_push_cadence():
    x, y = W.ps_problem()
    em = _emulator("downpour", 2, 5, seed=4)
    em.run(_data_iter(x, y, seed=5), 50)
    assert em.pushes == sum(e // 5 for e in em.events)


def test_device_sync_vs_emulated_async_delta():
    """Async DOWNPOUR reaches the optimum that sync LocalSGD reaches,
    along another trajectory."""
    x, y = W.ps_problem()
    em = _emulator("downpour", 4, 4, seed=6)
    losses = em.run(_data_iter(x, y, seed=7), 200)
    assert np.mean(losses[-5:]) < 1e-3


@pytest.mark.parametrize("mode,fetch", [("hogwild", 1), ("downpour", 4),
                                        ("adag", 4)])
def test_emulator_matches_jax(mode, fetch):
    """The same seed gives the same schedule of events, and the same
    losses and PS parameters as the JAX emulator (the gradients run on
    the CPU here)."""
    x, y = W.ps_problem()
    em = _emulator(mode, 4, fetch, seed=2)
    got = em.run(_data_iter(x, y, seed=3), 40)
    jem = JEmulator(lambda p, b: _jloss(p, b)[0],
                    {"w": jnp.zeros((DIM, 1))}, n_workers=4, mode=mode,
                    lr=0.05, fetch_period=fetch, seed=2)
    want = jem.run(({k: jnp.asarray(v) for k, v in b.items()}
                    for b in _data_iter(x, y, seed=3)), 40)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert em.pushes == jem.pushes and em.events == jem.events
    np.testing.assert_allclose(em.ps_params["w"].numpy(),
                               np.asarray(jem.ps_params["w"]), **PARAM_TOL)


# ---- the bridge ---------------------------------------------------------------------


def test_gossip_replicas_round_trip_is_bitwise():
    """The JAX GossipSGD's per-replica tree (leaves (8, ...), each row
    made different) -> one state dict a rank -> the tree, bitwise."""
    mesh = jbuild(JMeshSpec(data=-1))
    gs = jps.GossipSGD(mesh)
    params = jmnist.MNISTCNN().init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 28, 28, 1)))["params"]
    state = gs.distribute(train_state.TrainState.create(
        apply_fn=None, params=params, tx=optax.sgd(0.1)))
    rows = np.arange(8, dtype=np.float32)
    tree = jax.tree.map(
        lambda a: np.asarray(a) + rows.reshape(-1, *[1] * (a.ndim - 1)),
        state.params)
    replicas = bridge.gossip_replicas_from_flax(tree,
                                                bridge.mnist_cnn_from_flax)
    assert len(replicas) == 8
    np.testing.assert_array_equal(
        replicas[3]["dense1.bias"].numpy(),
        np.asarray(tree["Dense_1"]["bias"])[3])
    back = bridge.gossip_replicas_to_flax(replicas, bridge.mnist_cnn_to_flax)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
