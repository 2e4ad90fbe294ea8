"""The port's two-tier multi-slice strategy (``parallel/multislice.py``)
held to the JAX package's ``tests/test_multislice.py`` on the CPU.

One 4-rank gloo job (``tests/torch_mp_workers.py:multislice_job``, two
slices of two ranks) returns what the parent checks:

* the mesh: axes ``(dcn, data, model, pipe, context, expert)``, slices as
  contiguous rank blocks, the reference's refusals;
* ``sync_period=1`` (outer_lr 1, no momentum) equals sync DP over the four
  ranks (losses 1e-5 relative, weights 1e-5: the two-level reduction sums
  in another order);
* three outer rounds at ``sync_period=3`` with Nesterov outer momentum
  and inner SGD momentum against the reference's compiled two-tier step on
  four host CPU devices (2 x 2) from the same weights and super-batches:
  weights and outer momentum within 1e-6 (f32, the same algebra; the
  products sum in another order), and against the float64 host oracle of
  the reference test within 1e-4 as there;
* the collectives: one set across ``dcn`` a round whatever the period,
  the gradient average inside the slice every inner step, nothing across
  ``dcn`` with ``outer="off"``;
* ``outer_float_bytes`` equal to the reference's for the same model and
  optimizer (params, plus the SGD momentum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.training import train_state

from distributed_tensorflow_guide_tpu.core.mesh import (
    MeshSpec as JMeshSpec,
)
from distributed_tensorflow_guide_tpu.parallel import multislice as jms
from distributed_tensorflow_guide_tpu.train import elastic_world as jew
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core import mesh as tmesh
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.train import elastic_world as tew
from tests import torch_mp_workers as W


@pytest.fixture(scope="module")
def ranks():
    res = mp.run_multiprocess("tests.torch_mp_workers:multislice_job", 4,
                              timeout=240)
    return [r.result for r in sorted(res, key=lambda r: r.rank)]


def _loss(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["y"]) ** 2), {}


def test_two_tier_mesh_layout_and_refusals(ranks):
    for r, out in enumerate(ranks):
        assert out["names"] == ["dcn", *tmesh.AXES]
        assert out["shape"] == [2, 2, 1, 1, 1, 1]
        assert (out["dcn_index"], out["data_index"]) == divmod(r, 2)
        # slices are contiguous rank blocks: the elastic harness's layout
        assert out["slice_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert "do not split" in out["three_slices_error"]
        assert "two_tier_mesh" in out["flat_mesh_error"]


def test_sync_period1_equals_sync_dp(ranks):
    for out in ranks:
        np.testing.assert_allclose(out["p1_losses"][:, 0],
                                   out["p1_losses"][:, 1], rtol=1e-5)
        np.testing.assert_allclose(out["p1_w_ms"], out["p1_w_dp"],
                                   rtol=1e-5, atol=1e-6)
    for out in ranks[1:]:  # the replicas agree bitwise
        np.testing.assert_array_equal(out["p1_w_ms"], ranks[0]["p1_w_ms"])


def test_outer_rounds_match_the_references_two_tier_step(ranks):
    x, y = W.ms_problem()
    mesh = jms.two_tier_mesh(JMeshSpec(), devices=jax.devices()[:4],
                             n_slices=2)
    ms = jms.MultiSliceLocalSGD(mesh, W.MS_K, outer_lr=W.MS_OLR,
                                outer_momentum=W.MS_MU)
    state = ms.replicate(ms.init(train_state.TrainState.create(
        apply_fn=None, params={"w": jnp.asarray(W.ms_w0())},
        tx=optax.sgd(W.MS_ILR, momentum=0.9))))
    step = ms.make_train_step(_loss, donate=False)
    losses = []
    for r in range(W.MS_ROUNDS):
        state, m = step(state, ms.shard_batch(W.ms_superbatch(
            x, y, W.MS_K, W.MS_BATCH, seed=11 + r)))
        losses.append(float(m["loss"]))
    for out in ranks:
        params, momentum = bridge.two_tier_to_flax(
            {"weight": out["rounds_w"]}, {"weight": out["rounds_momentum"]},
            bridge.regression_to_flax)
        np.testing.assert_allclose(params["w"], state.inner.params["w"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(momentum["w"], state.outer_momentum["w"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["rounds_losses"], losses, rtol=1e-6)
        assert out["rounds_step"] == W.MS_ROUNDS * W.MS_K
    # the reference test's float64 host oracle (inner SGD momentum too)
    w = W.ms_w0().astype(np.float64)
    m = np.zeros_like(w)
    buf = [np.zeros_like(w), np.zeros_like(w)]
    for r in range(W.MS_ROUNDS):
        sb = W.ms_superbatch(x, y, W.MS_K, W.MS_BATCH, seed=11 + r)
        anchor = w.copy()
        per_slice, bufs = [], []
        for s in range(2):
            lo, hi = tew.shard_bounds(W.MS_BATCH, 2, s)
            ws, b = anchor.copy(), buf[s].copy()
            for j in range(W.MS_K):
                xs = sb["x"][j, lo:hi].astype(np.float64)
                ys = sb["y"][j, lo:hi].astype(np.float64)
                g = 2.0 * xs.T @ (xs @ ws - ys) / xs.shape[0]
                b = 0.9 * b + g
                ws = ws - W.MS_ILR * b
            per_slice.append(ws)
            bufs.append(b)
        buf = [np.mean(bufs, axis=0)] * 2  # the float opt state averaged
        delta = anchor - np.mean(per_slice, axis=0)
        m = W.MS_MU * m + delta
        w = anchor - W.MS_OLR * (delta + W.MS_MU * m)
    np.testing.assert_allclose(ranks[0]["rounds_w"], w.T, rtol=1e-4)


def test_two_tier_state_bridges_both_ways():
    """The reference's TwoTierState (inner parameters and outer momentum)
    into the port's state dict and momentum and back, exactly."""
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(W.MS_DIM, 1).astype(np.float32)}
    momentum = {"w": rng.randn(W.MS_DIM, 1).astype(np.float32)}
    sd, mom = bridge.two_tier_from_flax(params, momentum,
                                        bridge.regression_from_flax)
    assert sd["weight"].shape == mom["weight"].shape == (1, W.MS_DIM)
    back_p, back_m = bridge.two_tier_to_flax(sd, mom,
                                             bridge.regression_to_flax)
    np.testing.assert_array_equal(back_p["w"], params["w"])
    np.testing.assert_array_equal(back_m["w"], momentum["w"])


def test_outer_collectives_cross_dcn_once_per_round(ranks):
    out = ranks[0]
    k1, k4, off = out["calls_k1"], out["calls_k4"], out["calls_off"]
    assert k1["pmean[dcn]"] > 0 and k1["pmean[dcn]"] == k4["pmean[dcn]"]
    assert k4["pmean[data]"] == 4 * k1["pmean[data]"] > 0
    assert not any("dcn" in key for key in off)


def test_outer_float_bytes_equal_the_references(ranks):
    mesh = jms.two_tier_mesh(JMeshSpec(), devices=jax.devices()[:4],
                             n_slices=2)
    ms = jms.MultiSliceLocalSGD(mesh, 1)

    def ref(tx):
        return ms.outer_float_bytes(ms.init(train_state.TrainState.create(
            apply_fn=None, params={"w": jnp.asarray(W.ms_w0())}, tx=tx)))

    for out in ranks:
        assert out["float_bytes_plain"] == ref(optax.sgd(0.05)) == 24
        assert out["float_bytes_momentum"] == ref(
            optax.sgd(0.05, momentum=0.9)) == 48


def test_hybrid_device_array_and_slice_counts():
    sizes = {"data": 4, "model": 2, "pipe": 1, "context": 1, "expert": 1}
    arr = tmesh.hybrid_device_array(sizes, range(8), 2)
    assert arr.shape == (4, 2, 1, 1, 1)
    # slice 0 holds ranks 0-3: the outer half of the data axis
    assert sorted(arr[:2].ravel().tolist()) == [0, 1, 2, 3]
    assert tmesh.valid_slice_counts(sizes) == [1, 2, 4]
    with pytest.raises(ValueError, match="valid_slice_counts"):
        tmesh.hybrid_device_array(sizes, range(8), 3)
    assert tmesh.num_slices() == 1


def test_shard_bounds_tile_disjointly():
    for total in (8, 7, 12):
        for n in (1, 2, 3, 5):
            spans = [tew.shard_bounds(total, n, r) for r in range(n)]
            assert spans == [jew.shard_bounds(total, n, r)
                             for r in range(n)]
            pos = 0
            for lo, hi in spans:
                assert lo == pos
                pos = hi
            assert pos == total
    with pytest.raises(ValueError):
        tew.shard_bounds(8, 2, 2)


def _rec(gen, rnd, sl, lo, hi):
    return {"gen": gen, "round": rnd, "slice": sl, "lo": lo, "hi": hi}


GOOD = [_rec(0, 0, 0, 0, 4), _rec(0, 0, 1, 4, 8),
        _rec(0, 1, 0, 0, 4), _rec(0, 1, 1, 4, 8),
        _rec(0, 2, 0, 0, 4), _rec(0, 2, 1, 4, 8),
        _rec(1, 2, 0, 0, 8), _rec(1, 3, 0, 0, 8)]


@pytest.mark.parametrize("records,rounds,ok", [
    (GOOD, 4, True),
    (GOOD + [_rec(1, 3, 0, 0, 8)], 4, True),  # an in-generation replay
    (GOOD[:-1] + [_rec(1, 3, 0, 0, 6)], 4, False),  # a gap
    (GOOD + [_rec(1, 3, 1, 2, 8)], 4, False),  # an overlap
    (GOOD, 5, False),  # a round never consumed
], ids=["resize", "replay", "gap", "overlap", "missing"])
def test_verify_stream_accounting_equals_the_references(records, rounds,
                                                        ok):
    got = tew.verify_stream_accounting(records, rounds, 8)
    assert got == jew.verify_stream_accounting(records, rounds, 8)
    assert got[0] is ok
