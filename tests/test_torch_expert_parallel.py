"""The port's expert parallelism (``parallel/expert.py``) held to the JAX
package's on the same inputs, on the CPU: the routing, the MoE layer at
one rank, and ``ExpertParallel`` at data 1 x expert 2 and data 2 x expert
2 over gloo (one 4-rank job) against the reference on the same mesh of
fake CPU devices.

Tolerances: the one-hot plain routing against ``_topk_dispatch``,
bitwise; the index route's seats and gates, exactly; layer outputs and
the aux losses, f32 atol 1e-5 (the expert products sum in other orders);
updated parameters atol 1e-6. The reference's gradients are the token
shards' count n times the global loss's (under ``shard_map(check_vma=
False)`` its ``psum`` transposes to a psum); the port's are the global
loss's, so one reference SGD step at lr / n is held to the port's at lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_tensorflow_guide_tpu.core.compat import shard_map
from distributed_tensorflow_guide_tpu.parallel import expert as jep
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    AXES,
    AxisGroup,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh as TMesh
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.parallel import expert as EP
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from jax.sharding import PartitionSpec as P
from tests import torch_mp_workers as W


def _gates(t=16, e=4, seed=0):
    g = jax.nn.softmax(jnp.asarray(
        np.random.RandomState(seed).randn(t, e) * 2, jnp.float32), axis=-1)
    return g, torch.tensor(np.asarray(g))


@pytest.mark.parametrize("top_k,capacity", [(1, 16), (1, 3), (2, 16),
                                            (2, 5)])
def test_topk_dispatch_matches_the_reference(top_k, capacity):
    """The one-hot plain version bitwise; the index route seats each
    kept choice where the reference's dispatch has its 1, with its gate."""
    jg, tg = _gates()
    jd, jc = jep._topk_dispatch(jg, top_k, capacity)
    td, tc = EP.route_onehot(tg, top_k, capacity)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    r = EP.route(tg, top_k, capacity)
    seats = np.zeros_like(np.asarray(jd))
    gates = np.zeros_like(np.asarray(jc))
    for rows, w in zip(r.rows.numpy(), r.weights.numpy()):
        for t, row in enumerate(rows):
            if row < r.sink:
                seats[t, row // capacity, row % capacity] += 1
                gates[t, row // capacity, row % capacity] += w[t]
    assert np.array_equal(seats, np.asarray(jd))
    assert np.array_equal(gates, np.asarray(jc))
    assert (int(r.overflow.sum()) > 0) == (capacity < 16)


def _one_rank_reference(cfg, params, x):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "expert"))
    spec = {"router": P(), "w_in": P("expert"), "w_out": P("expert")}
    fn = shard_map(lambda p, t: jep.moe_ffn(p, t, cfg), mesh=mesh,
                   in_specs=(spec, P(("data", "expert"))),
                   out_specs=(P(("data", "expert")), P()), check_vma=False)
    return jax.jit(fn)(params, x)


@pytest.mark.parametrize("router,top_k,cf", [("switch", 1, 1.0),
                                             ("switch", 2, 2.0),
                                             ("dropless", 1, 1.0)])
@pytest.mark.parametrize("dispatch", ["index", "onehot"])
def test_moe_ffn_at_one_rank_matches_the_reference(router, top_k, cf,
                                                   dispatch):
    params, x, _ = W.ep_problem()
    jcfg = jep.MoEConfig(W.EP_DIM, W.EP_FF, W.EP_E, top_k=top_k,
                         capacity_factor=cf, router=router)
    y, aux = _one_rank_reference(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x))
    cfg = EP.MoEConfig(W.EP_DIM, W.EP_FF, W.EP_E, top_k=top_k,
                       capacity_factor=cf, router=router, dispatch=dispatch)
    with single_device_mesh():
        got, taux = EP.moe_ffn({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=0,
                               atol=1e-5)
    for k in ("load_balance", "z_loss"):
        np.testing.assert_allclose(taux[k].item(), float(aux[k]),
                                   rtol=1e-5)
    routed = top_k * W.EP_T
    assert int(taux["expert_load"].sum() + taux["dropped"]) == routed
    if router == "dropless":
        assert int(taux["dropped"]) == 0


def test_capacity_and_config_rules():
    cfg = EP.MoEConfig(8, 16, 4, top_k=2, capacity_factor=1.25)
    assert EP.capacity_of(cfg, 10) == 7  # ceil(2 * 10 * 1.25 / 4)
    assert EP.capacity_of(EP.MoEConfig(8, 16, 4, router="dropless"),
                          10) == 10
    assert cfg.token_axes == ("data", "expert")
    assert EP.MoEConfig(8, 16, 4, data_axis=None).token_axes == ("expert",)
    with pytest.raises(ValueError, match="router"):
        EP.MoEConfig(8, 16, 4, router="topk-drop")
    with pytest.raises(ValueError, match="dispatch"):
        EP.MoEConfig(8, 16, 4, dispatch="sorted")


def _expert2_mesh():
    """One rank's view of an expert axis of 2 (no group: the refusals come
    before any collective)."""
    sizes = {a: (2 if a == "expert" else 1) for a in AXES}
    return TMesh(sizes, 0, {a: AxisGroup(a, sizes[a], 0, (0,))
                            for a in AXES})


def test_the_references_refusals():
    mesh = _expert2_mesh()
    with pytest.raises(ValueError, match="divisible"):
        EP.ExpertParallel(mesh, EP.MoEConfig(4, 8, 3), device="cpu")
    cfg = EP.MoEConfig(4, 8, 4)
    gen = torch.Generator().manual_seed(0)
    full = EP.init_moe_params(cfg, gen)  # every expert: 4 local, not 2
    with mesh, pytest.raises(ValueError, match="local"):
        EP.moe_ffn(full, torch.zeros(16, 4), cfg)
    assert full["w_in"].shape == (4, 4, 8) and full["router"].shape == (4,
                                                                        4)


# ---- ExpertParallel over gloo against the reference on the same mesh --------


@pytest.fixture(scope="module")
def job():
    ranks = mp.run_multiprocess("tests.torch_mp_workers:ep_job", 4,
                                timeout=300)
    return [r.result for r in ranks]


def _jmesh(name):
    n_data = 1 if name == "data1-expert2" else 2
    return Mesh(np.asarray(jax.devices()[:2 * n_data]).reshape(n_data, 2),
                ("data", "expert"))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("name", [c[0] for c in W.EP_CASES])
def test_expert_parallel_matches_the_reference_on_the_same_mesh(job, name,
                                                                top_k):
    params, x, y = W.ep_problem()
    jcfg = jep.MoEConfig(W.EP_DIM, W.EP_FF, W.EP_E, top_k=top_k,
                         capacity_factor=W.EP_CF)
    ep = jep.ExpertParallel(_jmesh(name), jcfg)
    jp = ep.shard_params({k: jnp.asarray(v) for k, v in params.items()})
    want, aux = ep.apply(jp, jnp.asarray(x))
    want = np.asarray(want)
    n = _jmesh(name).devices.size
    # the reference's step at lr / n: its gradients are n times the
    # global loss's
    new, mets = ep.make_train_step(lr=W.EP_LR / n)(jp, jnp.asarray(x),
                                                   jnp.asarray(y))
    new = {k: np.asarray(v) for k, v in new.items()}
    per = W.EP_T // n
    e_per = W.EP_E // 2
    pre = f"{name}/k{top_k}"
    seen = set()
    for r in job:
        i, e = r[f"{name}/token_index"], r[f"{name}/expert_index"]
        seen.add(i)
        np.testing.assert_allclose(np.asarray(r[f"{pre}/y"]),
                                   want[i * per:(i + 1) * per], rtol=0,
                                   atol=1e-5)
        for k in ("load_balance", "z_loss"):
            np.testing.assert_allclose(r[f"{pre}/{k}"], float(aux[k]),
                                       rtol=1e-5)
        np.testing.assert_allclose(r[f"{pre}/loss"], float(mets["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(r[f"{pre}/new/router"]),
                                   new["router"], rtol=0, atol=1e-6)
        for k in ("w_in", "w_out"):
            np.testing.assert_allclose(
                np.asarray(r[f"{pre}/new/{k}"]),
                new[k][e * e_per:(e + 1) * e_per], rtol=0, atol=1e-6)
        tr = r[f"{pre}/trace"]
        # one all_to_all each way, a layer; the expert buffer (E, C, d)
        # f32, half of it to the other expert rank
        cap = max(1, int(np.ceil(top_k * per * W.EP_CF / W.EP_E)))
        assert tr["all_to_all[expert]"]["calls"] == 2
        assert tr["all_to_all[expert]"]["wire"] == (
            2 * W.EP_E * cap * W.EP_DIM * 4 / 2)
    assert seen == set(range(n))
