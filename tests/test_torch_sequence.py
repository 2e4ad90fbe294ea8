"""The port's sequence parallelism (``parallel/sequence.py``) held to the
JAX package on the inputs and geometries of ``tests/test_attention.py``.

One 8-rank gloo job (``tests/torch_mp_workers.py:sequence_job``) runs
every case on the context axis of a (data=8/n, context=n) mesh and hands
back each rank's shard of the output and of dq, dk, dv for the loss
sum(out ** 2) over the global output. Here the JAX package runs the same
case under ``shard_map`` over the conftest's 8 fake devices, its Pallas
kernels in interpret mode, and the shards are compared.

Tolerances, float32: 2e-5 absolute and relative on outputs and 1e-4 on
gradients, the JAX package's own for its ring against dense attention
(both sides sum the same products in other orders and another blocking).
bf16: the port's kernel ring against its blockwise ring at 2e-2, the JAX
package's own bf16 bound for the same pair.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_guide_tpu.core.compat import shard_map
from distributed_tensorflow_guide_tpu.core.mesh import MeshSpec as JMeshSpec
from distributed_tensorflow_guide_tpu.core.mesh import build_mesh as jbuild
from distributed_tensorflow_guide_tpu.parallel import sequence as jseq
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.parallel import sequence
from distributed_tensorflow_guide_tpu_torch.runtime.multiprocess import (
    run_multiprocess,
)
from tests import torch_mp_workers as W

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
JAX_IMPL = {"blockwise": "xla", "kernel": "pallas"}
F32_RING = [c for c in W.RING_CASES if c[-1] == "f32"]


@pytest.fixture(scope="module")
def job():
    """Each rank's result dict, in rank order."""
    results = run_multiprocess("tests.torch_mp_workers:sequence_job", 8,
                               timeout=240)
    return [r.result for r in results]


def _gathered(job, name, key, n):
    """The global (B, S, H, D) array from the shards of ranks 0..n-1 (the
    context axis of data index 0)."""
    return np.concatenate([job[r][f"{name}/{key}"] for r in range(n)],
                          axis=1)


def _jax_case(fn, n, shape, seed):
    """JAX output and (dq, dk, dv) of sum(out ** 2) under shard_map."""
    mesh = jbuild(JMeshSpec(data=8 // n, context=n, model=1, pipe=1))
    sm = shard_map(fn, mesh=mesh, in_specs=(P(None, "context"),) * 3,
                   out_specs=P(None, "context"), check_vma=False)
    q, k, v = (jnp.asarray(x) for x in W.qkv(seed, shape))
    out = jax.jit(sm)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(sm(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check(job, name, n, want_out, want_grads):
    np.testing.assert_allclose(_gathered(job, name, "out", n), want_out,
                               **OUT_TOL)
    for t, want in zip("qkv", want_grads):
        np.testing.assert_allclose(_gathered(job, name, f"d{t}", n), want,
                                   **GRAD_TOL, err_msg=f"d{t}")


@pytest.mark.parametrize("case", F32_RING, ids=[c[0] for c in F32_RING])
def test_ring_and_its_grads_match_jax(job, case):
    """The kernel ring (K4 forward, Q-side K2/K3 backward, here their
    plain versions) against JAX impl="pallas"; the blockwise ring against
    JAX impl="xla"; n = 2, 4 (and 8 for blockwise), causal and not."""
    name, impl, causal, n, shape, seed, _ = case
    fn = functools.partial(jseq.ring_attention, causal=causal,
                           impl=JAX_IMPL[impl])
    _check(job, name, n, *_jax_case(fn, n, shape, seed))


@pytest.mark.parametrize("case", W.ULYSSES_CASES,
                         ids=[c[0] for c in W.ULYSSES_CASES])
def test_ulysses_and_its_grads_match_jax(job, case):
    """Ulysses with the flash core (global S = 256 meets the JAX block
    rule) and with dense attention, against the JAX package's."""
    name, impl, causal, n, shape, seed, _ = case
    fn = functools.partial(jseq.ulysses_attention, causal=causal, impl=impl)
    _check(job, name, n, *_jax_case(fn, n, shape, seed))


def test_bf16_kernel_ring_matches_the_blockwise_ring(job):
    """The two ring implementations are interchangeable at bf16 (the JAX
    package pins its pallas and xla rings to each other the same way),
    forward and gradients."""
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(
            _gathered(job, "kernel-bf16", key, 2),
            _gathered(job, "blockwise-bf16", key, 2), **BF16_TOL,
            err_msg=key)


@pytest.mark.parametrize("n,causal,want", [
    (4, True, {"flash_carry_step": 10, "flash_bwd_dq": 10,
               "flash_bwd_dkv": 10}),
    (4, False, {"flash_carry_step": 16, "flash_bwd_dq": 16,
                "flash_bwd_dkv": 16}),
    (2, True, {"flash_carry_step": 3, "flash_bwd_dq": 3,
               "flash_bwd_dkv": 3}),
])
def test_kernel_ring_visits_live_shards_only(job, n, causal, want):
    """Summed over the ring's ranks, the kernel wrappers run once per live
    visit: causal, rank i's forward sees shards 0..i (i + 1 visits, one of
    them diagonal) and its backward the q shards i..n-1; dead visits are
    skipped but still take part in every hop."""
    name = f"kernel-n{n}-{'c' if causal else 'f'}"
    got = {}
    for r in range(n):
        for fn, c in job[r][f"{name}/calls"].items():
            got[fn] = got.get(fn, 0) + c
    assert got == want


def test_kernel_ring_refuses_a_ragged_cpu_shard_as_jax_does():
    """S_local = 96 is no multiple of 128: both packages refuse the kernel
    ring on the CPU instead of taking the other path; the blockwise ring
    takes it."""
    x = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="divisible by 128"):
        sequence.ring_attention(x, x, x, impl="kernel",
                                mesh=single_device_mesh())
    sequence.ring_attention(x, x, x, impl="blockwise",
                            mesh=single_device_mesh())
    mesh = jbuild(JMeshSpec(data=4, context=2, model=1, pipe=1))
    jx = jnp.zeros((1, 192, 2, 16))
    sm = shard_map(functools.partial(jseq.ring_attention, impl="pallas"),
                   mesh=mesh, in_specs=(P(None, "context"),) * 3,
                   out_specs=P(None, "context"), check_vma=False)
    with pytest.raises(ValueError, match="divisible by 128"):
        jax.eval_shape(sm, jx, jx, jx)


def test_ulysses_flash_refuses_a_ragged_cpu_length_as_jax_does():
    x = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="divisible by 128"):
        sequence.ulysses_attention(x, x, x, impl="flash",
                                   mesh=single_device_mesh())
    out = sequence.ulysses_attention(x, x, x, impl="auto",
                                     mesh=single_device_mesh())
    assert out.shape == x.shape


def test_auto_resolves_as_jax_on_the_cpu_and_to_the_kernel_on_a_card():
    assert jseq.RING_AUTO_IMPL == "xla"
    assert JAX_IMPL[sequence.RING_AUTO_IMPL] == jseq.RING_AUTO_IMPL
    assert sequence.resolve_ring_impl("auto", torch.device("cpu")) == (
        "blockwise")
    assert sequence.resolve_ring_impl("auto", torch.device("cuda", 0)) == (
        "kernel")
    assert sequence.resolve_ring_impl("blockwise", "cuda") == "blockwise"
    with pytest.raises(ValueError, match="unknown ring impl"):
        sequence.resolve_ring_impl("pallas", "cpu")


def test_a_context_axis_of_one_is_plain_attention():
    """One rank holding the whole sequence: each ring is the attention of
    that sequence, no collective runs."""
    from distributed_tensorflow_guide_tpu_torch.ops.attention import (
        dense_attention,
    )

    q, k, v = (torch.from_numpy(x) for x in W.qkv(7, (1, 128, 2, 16)))
    want = dense_attention(q, k, v, causal=True)
    for impl in ("kernel", "blockwise"):
        got = sequence.ring_attention(q, k, v, causal=True, impl=impl,
                                      mesh=single_device_mesh())
        torch.testing.assert_close(got, want, **OUT_TOL)
