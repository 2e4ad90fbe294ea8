"""The port's bucketed data-parallel all-reduce (``parallel/overlap.py``
and ``DataParallel(overlap=...)``) held to the JAX package's rules and to
the port's own monolithic path.

* The knob tables: ``overlap`` and ``prefetch`` resolve "auto" on under
  NCCL only (the JAX package's "TPU only"); ``compress="int8"`` is
  refused, naming the ROADMAP item that brings it.
* ``bucket_assignment`` equals the JAX function on the same byte lists.
  The buckets themselves differ between the packages (flax flattens its
  tree in sorted key order, ``named_parameters`` in registration order),
  so the step is pinned against the port's own monolithic ``pmean``.
* One 2-rank gloo job (``tests/torch_mp_workers.py:overlap_job``): one SGD
  step of a 14.4 MB transformer with the monolithic all-reduce and with
  every bucket budget of ``W.OV_BUCKETS`` (4 KiB to 32 MiB); the
  parameters must be the same bits (SGD makes them linear in the
  gradients, so the gradients are too), one all-reduce must run a bucket,
  and the bytes must be ``dp_allreduce_bytes``'. A step whose backward
  raises part-way must leave nothing for the next step to wait on. Then
  the ResNet stats step with 1 KiB buckets, bitwise.

Bitwise holds at two ranks: a sum of two terms is the same in any order.
At more ranks gloo's ring may add a buffer's elements in an order that
depends on its chunking, so the pins run at two.
"""

import numpy as np
import pytest
import torch

from benchmarks.common import dp_allreduce_bytes
from distributed_tensorflow_guide_tpu.parallel import overlap as jov
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.parallel import overlap
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from tests import torch_mp_workers as W


@pytest.fixture(scope="module")
def job():
    ranks = mp.run_multiprocess("tests.torch_mp_workers:overlap_job", 2,
                                timeout=300)
    return [r.result for r in ranks]


# ---- the knobs ------------------------------------------------------------------


@pytest.mark.parametrize("resolve", [overlap.resolve_overlap,
                                     overlap.resolve_prefetch])
def test_resolve_tables(resolve):
    for setting, want in ((True, True), (False, False), ("on", True),
                          ("off", False), ("true", True), ("0", False),
                          (None, False), ("auto", False)):
        assert resolve(setting) is want, setting
    assert resolve("auto", backend="nccl") is True
    assert resolve("auto", backend="gloo") is False
    assert resolve("off", backend="nccl") is False
    with pytest.raises(ValueError, match="auto"):
        resolve("maybe")


def test_resolve_compress_refuses_int8_until_it_is_ported():
    for setting in (None, "off", "none", "", "OFF"):
        assert overlap.resolve_compress(setting) is None
    with pytest.raises(NotImplementedError, match="item 9"):
        overlap.resolve_compress("int8")
    with pytest.raises(NotImplementedError, match="item 9"):
        DataParallel(overlap=True, compress="int8", device="cpu")
    with pytest.raises(ValueError, match="compress"):
        overlap.resolve_compress("zstd")


def test_overlap_refuses_accum_steps():
    cfg = ttf.TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                                d_model=16, d_ff=32, max_len=8,
                                dtype=torch.float32)
    loss_fn = ttf.make_lm_loss_fn(ttf.Transformer(cfg))
    dp = DataParallel(overlap=True, device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        dp.make_train_step(loss_fn, accum_steps=4)
    DataParallel(overlap=False, device="cpu").make_train_step(
        loss_fn, accum_steps=4)


def test_overlap_defaults_off_and_auto_is_off_without_nccl():
    assert DataParallel(device="cpu").overlap is False
    assert DataParallel(overlap="auto", device="cpu").overlap is False
    assert DataParallel(overlap="on", device="cpu").overlap is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DataParallel(overlap=True)


# ---- bucket partitioning ----------------------------------------------------------

BYTE_LISTS = [(10, 20, 30, 1000, 5, 5), (1,), (4096,) * 7,
              (100, 1 << 20, 3, 3 << 20, 5, 5, 5), tuple(range(1, 40))]


@pytest.mark.parametrize("budget", [1, 128, 4000, 4096, 1 << 20, 4 << 20,
                                    1 << 30])
def test_bucket_assignment_equals_the_jax_function(budget):
    for sizes in BYTE_LISTS:
        want = jov.bucket_assignment(
            [np.zeros(n, np.float32) for n in sizes], budget)
        assert overlap.bucket_assignment(
            [torch.zeros(n) for n in sizes], budget) == want


def test_bucket_assignment_rules():
    leaves = [torch.zeros(n) for n in (10, 20, 30, 1000, 5, 5)]
    groups = overlap.bucket_assignment(leaves, bucket_bytes=128)
    assert [i for g in groups for i in g] == list(range(len(leaves)))
    for g in groups:
        assert sum(4 * leaves[i].numel() for i in g) <= 128 or len(g) == 1
    assert [3] in groups  # the oversized leaf buckets alone
    assert overlap.bucket_assignment(leaves, 1 << 30) == [
        list(range(len(leaves)))]
    with pytest.raises(ValueError, match="bucket_bytes"):
        overlap.bucket_assignment(leaves, 0)
    assert overlap.DEFAULT_BUCKET_BYTES == 4 << 20


# ---- the 2-rank step -------------------------------------------------------------


@pytest.mark.parametrize("bb", W.OV_BUCKETS)
def test_bucketed_step_is_bitwise_the_monolithic_one(job, bb):
    for r in job:
        res = r[f"ov/{bb}"]
        assert res["bitwise"], f"rank {r['rank']}"
        assert res["loss"] == r["ov/ref_loss"]
    if bb < 16 << 20:  # budgets under the tree's size really split it
        assert job[0][f"ov/{bb}"]["buckets"] > 1


@pytest.mark.parametrize("bb", W.OV_BUCKETS)
def test_one_all_reduce_a_bucket_with_the_monolithic_bytes(job, bb):
    """A bucket's gradients go in one all-reduce (the metrics in one
    more); together they move ``dp_allreduce_bytes`` of the gradient
    tree, as the one monolithic all-reduce does."""
    param_bytes = job[0]["ov/param_bytes"]
    metric_bytes = 2 * 4  # loss, perplexity
    for r in job:
        res = r[f"ov/{bb}"]
        tr = res["trace"]["pmean[data]"]
        assert tr["calls"] == res["buckets"] + 1
        ref = r["ov/ref_trace"]["pmean[data]"]
        assert ref["calls"] == 2
        assert tr["bytes"] == ref["bytes"] == param_bytes + metric_bytes
        assert tr["wire"] == ref["wire"] == (
            dp_allreduce_bytes(param_bytes, 2)
            + dp_allreduce_bytes(metric_bytes, 2))


def test_a_backward_that_raises_leaves_nothing_for_the_next_step(job):
    """A step whose backward raises after some buckets were issued keeps
    the parameters as they were; the next step waits only on its own
    buckets and is bitwise the monolithic step."""
    for r in job:
        res = r["ov/raised"]
        assert res["raised"], f"rank {r['rank']}"
        assert 0 < res["issued"] < res["buckets"], res
        assert res["unchanged"]
        assert res["hooks_left"] == 0
        assert res["calls"] == res["buckets"] + 1
        assert res["bitwise"], f"rank {r['rank']}"


def test_the_stats_step_with_buckets_is_bitwise(job):
    """make_train_step_with_stats over the bucketed backward: parameters
    and running statistics the monolithic step's bits."""
    for r in job:
        assert r["ov/stats_bitwise"] is True
