"""The port's process mesh, collectives, comm trace, multi-rank data
parallelism, runner and launcher, held to numpy and to the JAX package.

One 4-rank gloo job (``tests/torch_mp_workers.py:collectives_job``) runs
every case and hands back each rank's results; the tests compare them
here, in the parent. The JAX side (mesh layout, traced comm sites,
``DataParallel``) runs on the conftest's 8 fake devices.

Tolerances: collectives against numpy, float32, 1e-6 absolute and relative
(sums of 4 values in another order). DP gradients and updated parameters
against the 1-rank step on the union batch and against JAX
``DataParallel``, float32, 1e-6 absolute and 1e-5 relative: the mean of
per-rank means against one mean over the union sums the same products in
another order. Comm counts and bytes are exact. The ResNet stats step's
running statistics against the mean of the two ranks' single-rank
updates, float32, 1e-6 absolute and relative (oneDNN's convolutions may
sum in another order in another process); across the ranks, bitwise.
"""

import subprocess
import sys
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state
from jax.sharding import PartitionSpec as P

import distributed_tensorflow_guide_tpu.collectives as jcc
from benchmarks.common import dp_allreduce_bytes
from distributed_tensorflow_guide_tpu.core.compat import shard_map
from distributed_tensorflow_guide_tpu.core.mesh import MeshSpec as JMeshSpec
from distributed_tensorflow_guide_tpu.core.mesh import build_mesh as jbuild
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.parallel import sequence as jseq
from distributed_tensorflow_guide_tpu.parallel.data_parallel import (
    DataParallel as JDataParallel,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core import device as tdevice
from distributed_tensorflow_guide_tpu_torch.core import dist as tdist
from distributed_tensorflow_guide_tpu_torch.core import mesh as tmesh
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from tests import torch_mp_workers as W

N = 4
TOL = dict(atol=1e-6, rtol=1e-6)
DP_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def job():
    """Each rank's result dict, in rank order."""
    results = mp.run_multiprocess("tests.torch_mp_workers:collectives_job",
                                  N, timeout=180)
    return [r.result for r in results]


def _inputs(seed=0):
    return [W.rank_input(r, (4, 6), seed=seed) for r in range(N)]


# ---- the mesh ----------------------------------------------------------------


@pytest.mark.parametrize("spec,n", [
    (dict(), 4), (dict(data=2, context=2), 4), (dict(data=-1, model=2), 8),
    (dict(data=1, context=-1), 8), (dict(data=3), 4), (dict(data=-1,
                                                            model=-1), 4),
    (dict(data=0), 4), (dict(model=3), 4),
])
def test_mesh_spec_resolves_as_jax(spec, n):
    try:
        want = JMeshSpec(**spec).resolve(n)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.MeshSpec(**spec).resolve(n)
        return
    assert tmesh.MeshSpec(**spec).resolve(n) == want
    assert tmesh.AXES == ("data", "model", "pipe", "context", "expert")


def test_build_mesh_groups_follow_the_jax_device_layout(job):
    """Rank r sits where device r sits in the JAX mesh of the same spec:
    its group along an axis is the ranks that differ from it only there."""
    jm = jbuild(JMeshSpec(data=2, context=2), devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(N):
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        for name in ("data", "model", "context"):
            ax = tmesh.AXES.index(name)
            line = list(where)
            line[ax] = slice(None)
            got = job[r]["mesh22"][name]
            assert got["ranks"] == ids[tuple(line)].tolist()
            assert got["index"] == where[ax]
            assert got["size"] == jm.shape[name]


def test_single_device_mesh_and_axis_resolution():
    mesh = tmesh.single_device_mesh()
    assert mesh.shape == (1,) * 5
    assert tmesh.axis_sizes(mesh) == {a: 1 for a in tmesh.AXES}
    with pytest.raises(RuntimeError, match="no active mesh"):
        tmesh.current_mesh()
    with mesh:
        assert tmesh.current_mesh() is mesh
        assert tmesh.resolve_axis("context").size == 1
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.axis("heads")
    # without a process group, build_mesh is the world of one
    assert tmesh.build_mesh().shape == (1,) * 5


# ---- collectives against numpy ---------------------------------------------------


def _expected(op):
    xs = _inputs()
    stack = np.stack(xs)
    ring = [xs[(r - 1) % N] for r in range(N)]
    w = [W.rank_input(r, (4, 6), seed=100) for r in range(N)]
    w2 = [W.rank_input(r, (1, 24), seed=200) for r in range(N)]
    return {
        "psum": [stack.sum(0)] * N,
        "pmean": [stack.mean(0)] * N,
        "pmax": [stack.max(0)] * N,
        "tree_a": [stack.sum(0)] * N,
        "tree_b": [2 * stack[:, :2].sum(0)] * N,
        "all_gather": [stack] * N,
        "all_gather_tiled": [np.concatenate(xs, axis=1)] * N,
        "reduce_scatter": [stack.sum(0)[r:r + 1] for r in range(N)],
        "ring_shift": ring,
        "ppermute_partial": [xs[2], xs[1], xs[0], np.zeros((4, 6))],
        # chunk j of rank r's rows goes to rank j, concatenated along dim 1
        "all_to_all": [np.concatenate([xs[s][r:r + 1] for s in range(N)],
                                      axis=1) for r in range(N)],
        # d/dx_r of sum_s ring_shift(x)_s * w_s: x_r lands on rank r + 1
        "ring_shift_grad": [w[(r + 1) % N] for r in range(N)],
        "all_to_all_grad": [np.stack([w2[s][0, 6 * r:6 * r + 6]
                                      for s in range(N)])
                            for r in range(N)],
    }[op]


OPS = ["psum", "pmean", "pmax", "tree_a", "tree_b", "all_gather",
       "all_gather_tiled", "reduce_scatter", "ring_shift",
       "ppermute_partial", "all_to_all", "ring_shift_grad",
       "all_to_all_grad"]


@pytest.mark.parametrize("op", OPS)
def test_collective_matches_numpy(job, op):
    for r, want in enumerate(_expected(op)):
        np.testing.assert_allclose(job[r][op], want, **TOL,
                                   err_msg=f"rank {r}")


def test_trace_counts_executed_calls_and_wire_bytes(job):
    """One record per executed call: payload is what the rank hands the
    op, wire what it sends (ring all-reduce 2P(n-1)/n, reduce-scatter and
    all-to-all P(n-1)/n, all-gather P(n-1), a permutation P per
    destination). The two
    differentiable ops record their backward calls as well."""
    p = 4 * 6 * 4  # one (4, 6) f32 input
    tr = job[0]["trace_collectives"]
    want = {
        "psum[data]": (2, p + (p + p // 2), 1.5 * (p + p // 2 + p)),
        "pmean[data]": (1, p, 1.5 * p),
        "pmax[data]": (1, p, 1.5 * p),
        "all_gather[data]": (2, 2 * p, 3.0 * 2 * p),
        # one pass of the ring: P(n-1)/n
        "reduce_scatter[data]": (1, p, p * (N - 1) / N),
        # ring_shift, the partial perm, ring_shift forward and backward
        "ppermute[data]": (4, 4 * p, 4.0 * p),
        # all_to_all, then forward and backward of the differentiated one
        "all_to_all[data]": (3, 3 * p, 0.75 * 3 * p),
    }
    assert {k: (v["calls"], v["bytes"], v["wire"]) for k, v in tr.items()
            } == want
    # rank 3 receives in the partial perm but sends nothing: less wire
    assert job[3]["trace_collectives"]["ppermute[data]"]["wire"] == 3 * p


def test_reinitialize_forms_the_group_again(job):
    for r in range(N):
        assert job[r]["reinitialized"] is True
        assert job[r]["after_reinit"].tolist() == [6.0]


# ---- SP comm against the JAX pins, in executed calls -------------------------

B, S, H, D = 2, 512, 8, 32  # tests/test_sp_comm.py's geometry
T = B * (S // N) * H * D * 4  # one f32 shard
THIN = T // D  # one f32 per (batch, head, position)


def _jax_sites(fn, grad=False):
    """Call sites the JAX package's trace records for ``fn`` over a context
    axis of 4 (a site inside the ring's scan runs n times)."""
    mesh = jbuild(JMeshSpec(data=-1, context=N))
    x = jnp.zeros((B, S, H, D), jnp.float32)
    sm = shard_map(fn, mesh=mesh, in_specs=(P(None, "context"),) * 3,
                   out_specs=P(None, "context"), check_vma=False)
    prog = (jax.grad(lambda q, k, v: jnp.sum(sm(q, k, v)),
                     argnums=(0, 1, 2)) if grad else sm)
    with jcc.trace_comm() as rec:
        jax.jit(prog).lower(x, x, x)
    return dict(rec.calls), dict(rec.bytes)


def test_ring_forward_comm_matches_the_jax_pin(job):
    """JAX: one K and one V ppermute site in the rotation scan, each a
    shard; executed n times each: 2n calls of one shard."""
    calls, nbytes = _jax_sites(lambda q, k, v: jseq.ring_attention(
        q, k, v, causal=True, impl="xla"))
    assert calls == {"ppermute[context]": 2}
    assert nbytes == {"ppermute[context]": 2 * T}
    for r in range(N):
        tr = job[r]["sp_traces"]["ring_fwd"]
        assert tr == {"ppermute[context]": {
            "calls": 2 * N, "bytes": 2 * N * T, "wire": 2 * N * T}}


def test_ulysses_comm_matches_the_jax_pin(job):
    """q, k, v seq -> heads and the output heads -> seq: 4 all_to_all
    calls of one shard, each run once."""
    calls, nbytes = _jax_sites(lambda q, k, v: jseq.ulysses_attention(
        q, k, v, causal=True, impl="dense"))
    assert calls == {"all_to_all[context]": 4}
    assert nbytes == {"all_to_all[context]": 4 * T}
    for r in range(N):
        tr = job[r]["sp_traces"]["ulysses_fwd"]["all_to_all[context]"]
        assert (tr["calls"], tr["bytes"]) == (4, 4 * T)
        assert tr["wire"] == 4 * T * (N - 1) / N


def test_kernel_ring_forward_and_backward_comm_matches_the_jax_pin(job):
    """JAX: 2 forward sites (k, v) and 5 backward sites (q, the output
    cotangent, the dq partial, lse and delta), each run n times: 2n + 5n
    calls moving n (2t + 3t + 2 t/D) bytes, unpadded and lane-thin."""
    calls, nbytes = _jax_sites(lambda q, k, v: jseq.ring_attention(
        q, k, v, causal=True, impl="pallas"), grad=True)
    assert calls == {"ppermute[context]": 7}
    assert nbytes == {"ppermute[context]": 5 * T + 2 * THIN}
    for r in range(N):
        tr = job[r]["sp_traces"]["ring_kernel_fwd_bwd"]["ppermute[context]"]
        assert tr["calls"] == 2 * N + 5 * N
        assert tr["bytes"] == N * (2 * T + 3 * T + 2 * THIN)


def test_ring_auto_shows_the_blockwise_signature_on_the_cpu(job):
    """As in the JAX package, impl="auto" on the CPU runs the blockwise
    ring: its trace is the blockwise one (autograd's backward of the k/v
    hops, 2 (n - 1) of them: the last hop's result has no gradient), not
    the kernel ring's."""
    tr = job[0]["sp_traces"]
    assert tr["ring_auto_fwd_bwd"] == tr["ring_blockwise_fwd_bwd"]
    assert tr["ring_blockwise_fwd_bwd"]["ppermute[context]"]["calls"] == (
        2 * N + 2 * (N - 1))
    assert tr["ring_kernel_fwd_bwd"] != tr["ring_blockwise_fwd_bwd"]


# ---- multi-rank data parallelism -------------------------------------------------

CFG = ttf.TransformerConfig(**W.DP_GEOM, dtype=torch.float32,
                            attn_impl="dense")
JCFG = jtf.TransformerConfig(**W.DP_GEOM, dtype=jnp.float32,
                             attn_impl="dense")
DP_CASES = [("dp4", 4), ("dp2", 2), ("dp2acc", 2)]


@pytest.fixture(scope="module")
def union():
    """The 1-rank step on the union batch: (grads, updated params)."""
    model = ttf.Transformer(CFG).init_weights(0)
    loss_fn = ttf.make_lm_loss_fn(model, fused_ce=False)
    tokens = W.dp_tokens()
    _, grads = value_and_grad(loss_fn, model,
                              {"tokens": torch.as_tensor(tokens)})
    state = TrainState(model, torch.optim.SGD(model.parameters(),
                                              lr=W.DP_LR))
    DataParallel(device="cpu").make_train_step(loss_fn)(
        state, {"tokens": tokens})
    return grads, {k: v.clone() for k, v in model.state_dict().items()}


def _jax_dp_params(n):
    """JAX DataParallel over n fake devices, one SGD step on the union
    batch from the port's initial weights (bridged)."""
    tree = bridge.params_to_flax(
        ttf.Transformer(CFG).init_weights(0).state_dict(), CFG)
    jmodel = jtf.Transformer(JCFG)
    dp = JDataParallel(jbuild(JMeshSpec(data=n), devices=jax.devices()[:n]))
    step = dp.make_train_step(jtf.make_lm_loss_fn(jmodel, fused_ce=False),
                              donate=False)
    state = dp.replicate(train_state.TrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, tree),
        tx=optax.sgd(W.DP_LR)))
    state, _ = step(state, dp.shard_batch({"tokens": W.dp_tokens()}))
    return jax.tree.map(np.asarray, fnn.meta.unbox(state.params))


@pytest.mark.parametrize("tag,n", DP_CASES, ids=[c[0] for c in DP_CASES])
def test_dp_step_matches_the_union_step_and_jax(job, union, tag, n):
    """Every rank of an n-rank step ends with the 1-rank step's averaged
    gradients and updated parameters on the union batch, and with JAX
    DataParallel's parameters over n devices."""
    grads, params = union
    want_jax = bridge.params_from_flax(_jax_dp_params(n), CFG)
    for r in range(N):
        res = job[r]
        for name in grads:
            np.testing.assert_allclose(res[f"{tag}/grad/{name}"],
                                       grads[name].numpy(), **DP_TOL,
                                       err_msg=f"rank {r} grad {name}")
        for name in params:
            got = res[f"{tag}/param/{name}"]
            np.testing.assert_allclose(got, params[name].numpy(), **DP_TOL,
                                       err_msg=f"rank {r} {name}")
            np.testing.assert_allclose(got, want_jax[name].numpy(),
                                       **DP_TOL, err_msg=f"rank {r} {name}")
        # every rank reports the union loss
        assert res[f"{tag}/loss"].shape == ()
    losses = {float(job[r][f"{tag}/loss"]) for r in range(N)}
    assert len(losses) == 1


@pytest.mark.parametrize("tag,n", DP_CASES, ids=[c[0] for c in DP_CASES])
def test_dp_allreduce_bytes_equal_the_closed_form(job, union, tag, n):
    """The step's two all-reduces (the gradients, then the loss and its
    metrics) put dp_allreduce_bytes of their payloads on the wire."""
    grad_bytes = sum(g.numel() * 4 for g in union[0].values())
    tr = job[0][f"{tag}_trace"]["pmean[data]"]
    assert tr["calls"] == 2
    mets = tr["bytes"] - grad_bytes
    assert mets == 2 * 4  # loss and perplexity, f32 scalars
    assert tr["wire"] == pytest.approx(
        dp_allreduce_bytes(grad_bytes, n) + dp_allreduce_bytes(mets, n),
        rel=1e-12)


def test_stats_step_averages_the_running_statistics_bitwise(job):
    """The data axis of 2 holds ranks {0, 2} and {1, 3}: after one
    ``make_train_step_with_stats`` step each rank's running statistics are
    the mean of the single-rank updates of the two halves of the union
    batch, and every rank holds the same statistics and parameters, bit
    for bit."""
    batch = W.stats_batch()
    updates = []
    for i in range(2):
        model = W.stats_model().train()
        with torch.no_grad():
            model(torch.as_tensor(batch["image"][4 * i:4 * (i + 1)]))
        updates.append({n: b for n, b in model.named_buffers()})
    names = list(updates[0])
    assert names and all(n.endswith(("running_mean", "running_var"))
                         for n in names)
    init = dict(W.stats_model().named_buffers())
    for n in names:
        want = ((updates[0][n] + updates[1][n]) / 2).numpy()
        assert not np.allclose(want, init[n].numpy()), n  # they moved
        for r in range(N):
            np.testing.assert_allclose(job[r][f"stats/{n}"], want, **TOL,
                                       err_msg=f"rank {r} {n}")
    for key in (k for k in job[0] if k.startswith("stats/")):
        for r in range(1, N):
            assert np.array_equal(job[r][key], job[0][key]), (r, key)
    # one all-reduce each: the gradients, the statistics, the metrics
    tr = job[0]["stats_trace"]["pmean[data]"]
    assert tr["calls"] == 3
    stat_bytes = sum(b.numel() * 4 for b in init.values())
    grad_bytes = sum(p.numel() * 4 for p in W.stats_model().parameters())
    assert tr["bytes"] == grad_bytes + stat_bytes + 2 * 4


# ---- process bootstrap, runner and launcher ----------------------------------------


def test_dist_config_reads_the_environment(monkeypatch):
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="1234", RANK="2",
                     WORLD_SIZE="4", LOCAL_RANK="2",
                     LOCAL_WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    cfg = tdist.DistConfig.from_env()
    assert cfg == tdist.DistConfig("localhost", 1234, 2, 4, 2, 4)
    assert not cfg.single_process
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdist.default_backend(cfg) == "gloo"  # 4 ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdist.default_backend(cfg) == "nccl"


def test_a_single_process_initialises_nothing():
    assert tdist.DistConfig().single_process
    assert tdist.initialize(tdist.DistConfig(world_size=1)) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tdist.initialize(tdist.DistConfig(world_size=2, rank=0))


def test_initialize_registers_shutdown_which_destroys_the_group(
        monkeypatch, tmp_path):
    """A rank that joins a group gets ``shutdown`` registered at exit,
    once however often it joins; ``shutdown`` destroys the group and
    forgets the store. (The group here is a world of one over a file
    store standing in for the TCP store.)"""
    registered = []
    monkeypatch.setattr(tdist.atexit, "register", registered.append)
    monkeypatch.setattr(tdist.atexit, "unregister", lambda fn: [
        registered.remove(f) for f in list(registered) if f is fn])
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    monkeypatch.setattr(tdist, "_tcp_store", lambda config, timeout: store)
    init = torch.distributed.init_process_group
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, *, store, rank, world_size, timeout:
                        init(backend, store=store, rank=0, world_size=1))
    config = tdist.DistConfig(master_addr="localhost", master_port=1,
                              rank=0, world_size=2)
    try:
        assert tdist.initialize(config, backend="gloo")
        assert tdist.reinitialize(config, backend="gloo")
        assert registered == [tdist.shutdown]
    finally:
        tdist.shutdown()
    assert not torch.distributed.is_initialized()
    assert tdist._STORE == {"where": None, "store": None, "groups": 0}
    tdist.shutdown()  # nothing left to do


def test_resolve_device_maps_local_rank_onto_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdevice.resolve_device(None) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdevice.resolve_device(None) == torch.device("cuda", 3)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert tdevice.resolve_device(None) == torch.device("cuda", 0)


def test_runner_reports_a_failed_rank_and_reaps_the_rest():
    t0 = time.monotonic()
    with pytest.raises(mp.MultiProcessError, match="rank 1 fails") as e:
        mp.run_multiprocess(W.fail_on_rank, 2, [1], timeout=60)
    codes = {r.rank: r.returncode for r in e.value.results}
    assert codes[1] not in (0, None) and codes[0] != 0
    assert time.monotonic() - t0 < 45  # the grace period, not the timeout


def test_runner_times_out():
    runner = mp.MultiProcessRunner(W.sleep_long, 2, timeout=6).start()
    with pytest.raises(mp.MultiProcessError, match="timeout"):
        runner.join()


def test_runner_refuses_a_target_it_cannot_import():
    with pytest.raises(ValueError, match="module-level"):
        mp.MultiProcessRunner(lambda: None, 2)


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "rank1_fails"])
def test_launch_prefixes_output_and_supervises(fail):
    cmd = [sys.executable, "-m", "distributed_tensorflow_guide_tpu_torch.launch",
           "-n", "2", "--device", "cpu", "--failure-grace", "3",
           "--timeout", "120", "tests/torch_mp_workers.py"]
    if fail:
        cmd += ["--fail-rank", "1"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=150)
    out = proc.stdout
    if fail:
        assert proc.returncode == 1
        assert "[p1] rank 1 failing on purpose" in out
        assert "exited 3" in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr[-2000:]
    for r in range(2):
        assert f"[p{r}] rank {r} of 2 backend gloo psum 1 cuda False" in out
    assert "launch: exit codes [0, 0]" in out
