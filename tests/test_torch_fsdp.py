"""The port's FSDP (``parallel/fsdp.py``) held to the JAX package's.

* ``shard_spec_for`` equals the JAX function over a grid of shapes, worlds
  and minimum sizes; ``fsdp_comm_terms`` equals ``benchmarks/common.py``'s.
* One 2-rank gloo job (``tests/torch_mp_workers.py:fsdp_job``) runs
  tests/test_fsdp.py's MNIST CNN run (SGD 0.1, momentum 0.9, leaves of
  1024 elements and more sharded, 5 batches of 32) through the port's
  ``FSDP`` with both ``prefetch`` values and through ``DataParallel``.
  The JAX ``FSDP`` runs the same weights and batches on 2 of the
  conftest's 8 fake devices while the ranks run, with ``prefetch`` off
  (GSPMD's schedule) and on (the manual one).
* Per-rank state bytes shrink with the world (in-process, the layout
  needs no collective), the first step's collectives are counted
  exactly, and the bridge's FSDP round trip is bitwise.

Tolerances: tests/test_fsdp.py's, float32: each step's loss
``rtol=1e-5``, the parameters after the run ``rtol=1e-4, atol=1e-6``; the
eval metrics ``rtol=1e-5``. Comm counts and bytes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from benchmarks.common import dp_allreduce_bytes
from benchmarks.common import fsdp_comm_terms as j_fsdp_comm_terms
from distributed_tensorflow_guide_tpu.data.synthetic import (
    synthetic_mnist as j_synthetic_mnist,
)
from distributed_tensorflow_guide_tpu.models import mnist_cnn as jmnist
from distributed_tensorflow_guide_tpu.parallel.fsdp import FSDP as JFSDP
from distributed_tensorflow_guide_tpu.parallel.fsdp import (
    shard_spec_for as j_shard_spec_for,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    AXES,
    AxisGroup,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh as TMesh
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.models import mnist_cnn
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel import fsdp, overlap
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from tests import torch_mp_workers as W

LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
TAGS = ("fsdp-off", "fsdp-on")


@pytest.fixture(scope="module")
def job():
    """Each rank's results, with the JAX runs made while the ranks run."""
    runner = mp.MultiProcessRunner("tests.torch_mp_workers:fsdp_job", 2,
                                   timeout=300).start()
    try:
        jax_runs = {p: _jax_fsdp_run(p) for p in (False, True)}
    finally:
        ranks = [r.result for r in runner.join()]
    return ranks, jax_runs


def _jax_fsdp_run(prefetch: bool):
    """The JAX FSDP run on 2 fake devices from the port's initial weights
    (bridged): the losses and the final parameters as a port state
    dict."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    model = jmnist.MNISTCNN()
    fs = JFSDP(mesh, min_shard_size=W.FSDP_MIN_SHARD, prefetch=prefetch)
    _, shardings = fs.init_params(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"])
    tree = bridge.mnist_cnn_to_flax(
        mnist_cnn.MNISTCNN().init_weights(0).state_dict())
    params = jax.device_put(jax.tree.map(jnp.asarray, tree), shardings)
    state = train_state.TrainState.create(
        apply_fn=model.apply, params=params,
        tx=optax.sgd(W.FSDP_LR, momentum=0.9))
    st = fs.state_shardings(state, shardings)
    state = jax.device_put(state, st)
    step = fs.make_train_step(jmnist.make_loss_fn(model), st, donate=False)
    losses = []
    for b in j_synthetic_mnist(W.FSDP_B, seed=7).take(W.FSDP_STEPS):
        state, m = step(state, jax.device_put(
            b, NamedSharding(mesh, P("data"))))
        losses.append(float(m["loss"]))
    return losses, bridge.mnist_cnn_from_flax(
        jax.tree.map(np.asarray, jax.device_get(state.params)))


def _sub(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


# ---- the layout ---------------------------------------------------------------

SHAPES = [(256, 512), (1024, 384), (128,), (270, 130), (3, 3, 32, 64),
          (64, 32, 3, 3), (3136, 128), (128, 3136), (50304, 768),
          (768, 3072), (2304, 768), (768, 768), (12, 64, 768), (16384,),
          (16383,), (6, 1), (), (5, 4096), (4096, 5), (8, 8, 8, 8)]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_shard_spec_for_equals_the_jax_function(world):
    for shape in SHAPES:
        for min_size in (1, 2 ** 10, 2 ** 14):
            want = tuple(j_shard_spec_for(shape, world, min_size))
            assert fsdp.shard_spec_for(shape, world, min_size) == want, (
                shape, min_size)


def test_fsdp_comm_terms_is_the_jax_closed_form():
    for sharded in (0.0, 1.0, 1684480.0, 4.97e8):
        for world in (1, 2, 3, 8):
            for repl in (0.0, 2096.0):
                assert fsdp.fsdp_comm_terms(sharded, world, repl) == (
                    j_fsdp_comm_terms(sharded, world, repl))


def _fake_mesh(world: int) -> TMesh:
    """A mesh of ``world`` ranks on the data axis as rank 0 sees it, with
    no process group: enough to lay out shards, not to run a step."""
    axes = {a: AxisGroup(a, world if a == "data" else 1, 0,
                         tuple(range(world if a == "data" else 1)))
            for a in AXES}
    return TMesh({a: axes[a].size for a in AXES}, 0, axes)


def test_state_bytes_shrink_with_the_world():
    """tests/test_fsdp.py's transformer: params and Adam's two moments a
    rank shrink ~world-fold; only biases and norms stay whole."""
    cfg = ttf.TransformerConfig(vocab_size=4096, num_layers=2, num_heads=4,
                                d_model=256, d_ff=1024, max_len=32,
                                dtype=torch.float32)
    full = ttf.Transformer(cfg).init_weights(0)
    per_world = {}
    for world in (1, 2, 4, 8):
        fs = fsdp.FSDP(_fake_mesh(world), device="cpu")
        local = fs.shard(full)
        # Adam keeps two moments of each parameter's (shard's) shape
        per_world[world] = 3 * fs.state_bytes(local)["params"]
        for n, p in local.named_parameters():
            dim = overlap.sharded_dim(fs.specs[n], "data")
            want = list(full.state_dict()[n].shape)
            if dim is not None:
                want[dim] //= world
            assert list(p.shape) == want, n
    assert per_world[1] == 3 * 4 * sum(p.numel() for p in full.parameters())
    assert all(per_world[a] > per_world[b]
               for a, b in ((1, 2), (2, 4), (4, 8)))
    assert per_world[1] / per_world[8] > 6, per_world


def test_entry_points_default_to_the_card():
    """``device=None`` is the card, and raises without one; a module that
    ``FSDP.shard`` did not lay out is refused."""
    if torch.cuda.is_available():
        assert fsdp.FSDP(single_device_mesh()).device == torch.device(
            "cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fsdp.FSDP(single_device_mesh())
    fs = fsdp.FSDP(single_device_mesh(), device="cpu")
    model = mnist_cnn.MNISTCNN()  # not laid out by fs.shard
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(ValueError, match="FSDP.shard"):
        fs.make_train_step(mnist_cnn.make_loss_fn(model))(
            state, W.fsdp_batches()[0])


# ---- the 2-rank run against JAX and DataParallel --------------------------------


@pytest.mark.parametrize("tag", TAGS)
def test_fsdp_steps_equal_the_jax_fsdp(job, tag):
    """Each step's loss and the parameters after 5 steps equal the JAX
    FSDP's, prefetch off against GSPMD's schedule, on against the
    manual one."""
    ranks, jax_runs = job
    want_losses, want = jax_runs[tag == "fsdp-on"]
    for r in ranks:
        got = [float(r[f"{tag}/loss{t}"]) for t in range(W.FSDP_STEPS)]
        np.testing.assert_allclose(got, want_losses, **LOSS_TOL)
        params = _sub(r, f"{tag}/param/")
        assert params.keys() == want.keys()
        for k, t in want.items():
            np.testing.assert_allclose(params[k], t.numpy(), **PARAM_TOL,
                                       err_msg=f"rank {r['rank']} {k}")


@pytest.mark.parametrize("tag", TAGS)
def test_fsdp_equals_sync_data_parallel(job, tag):
    """FSDP is a layout, not another algorithm: the losses, the eval
    metrics and the parameters of the replicated DP run."""
    ranks, _ = job
    for r in ranks:
        for t in range(W.FSDP_STEPS):
            np.testing.assert_allclose(r[f"{tag}/loss{t}"],
                                       r[f"dp/loss{t}"], **LOSS_TOL)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(r[f"{tag}/eval/{k}"],
                                       r[f"dp/eval/{k}"], **LOSS_TOL)
        dp = _sub(r, "dp/param/")
        for k, t in _sub(r, f"{tag}/param/").items():
            np.testing.assert_allclose(t, dp[k], **PARAM_TOL, err_msg=k)


def test_both_prefetch_values_give_the_same_numbers(job):
    ranks, _ = job
    for r in ranks:
        off, on = (_sub(r, f"{t}/shard/") for t in TAGS)
        for k in off:
            np.testing.assert_array_equal(off[k], on[k], err_msg=k)
        assert r["fsdp-off/trace"] == r["fsdp-on/trace"]


def test_parameters_and_moments_are_sharded(job):
    """Each rank holds its half of each sharded leaf, the whole of the
    replicated ones, and as many momentum bytes as parameter bytes; the
    two ranks' shards differ and together make the full parameter."""
    ranks, _ = job
    specs = ranks[0]["fsdp/specs"]
    sharded = [n for n, sp in specs.items() if "data" in sp]
    assert sharded == ["conv1.weight", "dense0.weight", "dense1.weight"]
    full = mnist_cnn.MNISTCNN().state_dict()
    for tag in TAGS:
        want = 0
        for n, t in full.items():
            shape = list(t.shape)
            if n in sharded:
                shape[specs[n].index("data")] //= 2
            assert ranks[0][f"{tag}/local_shapes"][n] == shape, n
            want += 4 * int(np.prod(shape))
        for r in ranks:
            assert r[f"{tag}/bytes"] == {"params": want, "optimizer": want}
        for n in sharded:
            a, b = (r[f"{tag}/shard/{n}"] for r in ranks)
            dim = specs[n].index("data")
            np.testing.assert_array_equal(
                np.concatenate([a, b], axis=dim), ranks[0][f"{tag}/param/{n}"])


@pytest.mark.parametrize("tag", TAGS)
def test_collective_counts_and_bytes_are_exact(job, tag):
    """One all-gather and one reduce-scatter a sharded leaf, one pmean a
    replicated leaf and a metric (loss, accuracy); the wire bytes are
    ``fsdp_comm_terms``'s, the metrics' two scalar all-reduces added."""
    ranks, _ = job
    specs = ranks[0]["fsdp/specs"]
    full = mnist_cnn.MNISTCNN().state_dict()
    sharded_bytes = sum(4 * full[n].numel() for n, sp in specs.items()
                        if "data" in sp)
    repl_bytes = sum(4 * full[n].numel() for n, sp in specs.items()
                     if "data" not in sp)
    terms = fsdp.fsdp_comm_terms(sharded_bytes, 2, repl_bytes)
    for r in ranks:
        tr = r[f"{tag}/trace"]
        assert {k: v["calls"] for k, v in tr.items()} == {
            "all_gather[data]": 3, "reduce_scatter[data]": 3,
            "pmean[data]": 5 + 2}
        assert tr["all_gather[data]"]["wire"] == terms["param_all_gather"]
        assert tr["reduce_scatter[data]"]["wire"] == (
            terms["grad_reduce_scatter"])
        assert tr["pmean[data]"]["wire"] == (
            terms["replicated_grad_allreduce"]
            + 2 * dp_allreduce_bytes(4, 2))


# ---- the bridge -------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_bridge_round_trip_is_bitwise(world):
    """A JAX tree -> every rank's FSDP shards -> the full state dict ->
    the JAX tree, bitwise: the MNIST CNN and a transformer."""
    cnn = jax.tree.map(np.asarray, jmnist.MNISTCNN().init(
        jax.random.PRNGKey(1), jnp.zeros((1, 28, 28, 1)))["params"])
    tcfg = ttf.TransformerConfig(vocab_size=256, num_layers=2, num_heads=4,
                                 d_model=64, d_ff=256, max_len=32,
                                 dtype=torch.float32)
    lm = bridge.params_to_flax(ttf.Transformer(tcfg).init_weights(3)
                               .state_dict(), tcfg)
    for tree, from_flax, to_flax in (
            (cnn, bridge.mnist_cnn_from_flax, bridge.mnist_cnn_to_flax),
            (lm, lambda t: bridge.params_from_flax(t, tcfg),
             lambda sd: bridge.params_to_flax(sd, tcfg))):
        parts = [bridge.fsdp_params_from_flax(tree, from_flax, world, i,
                                              min_shard_size=2 ** 10)
                 for i in range(world)]
        specs = fsdp.param_specs(from_flax(tree), world, 2 ** 10)
        assert any("data" in sp for sp in specs.values())
        back = bridge.fsdp_params_to_flax(parts, to_flax, specs)
        flat_a, tree_a = jax.tree.flatten(tree)
        flat_b, tree_b = jax.tree.flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b)
