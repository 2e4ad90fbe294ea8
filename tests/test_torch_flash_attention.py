"""The port's flash attention (K1-K4 plain versions, the autograd
Function, the fallback rule, the ring carry's init and finalize) and
blockwise/dense attention, held to the JAX package on the same inputs.

The JAX kernels run in Pallas interpret mode on the CPU, with blocks
pinned to 32 so that S = 64 and 128 reach the kernels, not the fallback.
Inputs are made with numpy from a seed and handed to both; the tests
that run JAX's backward kernels use one head (the interpret mode's cost
grows with the grid), the forward test two.

Tolerances (float32 throughout unless stated): 2e-5 absolute and relative
for outputs, LSE and gradients. Both sides compute in f32 over the same
products; only the summation order differs (other tile sizes, another
framework). The bf16 case holds the port's bf16 output to its own f32
output within 1e-2, one bf16 step at |x| < 2.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.ops import attention as jattn
from distributed_tensorflow_guide_tpu.ops import flash_attention as jfa
from distributed_tensorflow_guide_tpu_torch.ops import attention as tattn
from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as FA

TOL = dict(atol=2e-5, rtol=2e-5)
BLK = 32
CASES = [(causal, hd, s) for causal in (True, False) for hd in (32, 40, 64)
         for s in (64, 128)]
IDS = [f"{'causal' if c else 'full'}-hd{hd}-s{s}" for c, hd, s in CASES]


@pytest.fixture(autouse=True)
def _isolated_table(isolated_autotune_table):
    yield


def _inputs(s, hd, seed=0, b=1, h=2, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, hd).astype(np.float32) for _ in range(n)]


def _kernel_layout(x):
    """(B, S, H, D) numpy -> the JAX kernels' (B, H, S, D)."""
    return jnp.asarray(np.transpose(x, (0, 2, 1, 3)))


def _lanes(x):
    """(B, H, S) -> the JAX kernels' lane-broadcast (B, H, S, 128)."""
    return jnp.broadcast_to(jnp.asarray(x)[..., None], x.shape + (jfa.LANE,))


def _bshd(x):
    """The JAX kernels' (B, H, S, D) -> (B, S, H, D) numpy."""
    return np.transpose(np.asarray(x), (0, 2, 1, 3))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("causal,hd,s", CASES, ids=IDS)
def test_plain_forward_matches_the_pallas_forward(causal, hd, s):
    q, k, v = _inputs(s, hd, n=3)
    scale = 1.0 / hd ** 0.5
    j_out, j_lse = jfa._fwd_call(
        *(_kernel_layout(x) for x in (q, k, v)), scale=scale, causal=causal,
        blk_q=BLK, blk_k=BLK)
    out, lse = FA.flash_fwd_plain(_t(q), _t(k), _t(v), scale, causal)
    np.testing.assert_allclose(out.numpy(), _bshd(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               **TOL)


def _bwd_inputs(s, hd, causal):
    """q, k, v, dO and the LSE and delta both backward kernels read, from
    the JAX forward."""
    q, k, v, do = _inputs(s, hd, seed=1, h=1)
    scale = 1.0 / hd ** 0.5
    j_out, j_lse = jfa._fwd_call(
        *(_kernel_layout(x) for x in (q, k, v)), scale=scale, causal=causal,
        blk_q=BLK, blk_k=BLK)
    lse = np.asarray(j_lse)[..., 0]
    delta = np.sum(do * _bshd(j_out), axis=-1).transpose(0, 2, 1)
    return q, k, v, do, lse, np.ascontiguousarray(delta), scale


@pytest.mark.parametrize("causal,hd,s", CASES, ids=IDS)
def test_plain_dq_matches_the_pallas_dq_kernel(causal, hd, s):
    q, k, v, do, lse, delta, scale = _bwd_inputs(s, hd, causal)
    j_dq = jfa._bwd_dq_call(
        *(_kernel_layout(x) for x in (q, k, v, do)), _lanes(lse),
        _lanes(delta), scale=scale, causal=causal, blk_q=BLK, blk_k=BLK)
    dq = FA.flash_bwd_dq_plain(*(_t(x) for x in (q, k, v, do, lse, delta)),
                               scale, causal)
    np.testing.assert_allclose(dq.numpy(), _bshd(j_dq), **TOL)


@pytest.mark.parametrize("causal,hd,s", CASES, ids=IDS)
def test_plain_dkv_matches_the_pallas_dkv_kernel(causal, hd, s):
    q, k, v, do, lse, delta, scale = _bwd_inputs(s, hd, causal)
    j_dk, j_dv = jfa._bwd_dkv_call(
        *(_kernel_layout(x) for x in (q, k, v, do)), _lanes(lse),
        _lanes(delta), scale=scale, causal=causal, blk_q=BLK, blk_k=BLK)
    dk, dv = FA.flash_bwd_dkv_plain(
        *(_t(x) for x in (q, k, v, do, lse, delta)), scale, causal)
    np.testing.assert_allclose(dk.numpy(), _bshd(j_dk), **TOL)
    np.testing.assert_allclose(dv.numpy(), _bshd(j_dv), **TOL)


@pytest.mark.parametrize("causal,hd,s", CASES, ids=IDS)
def test_flash_attention_and_its_grads_match_jax(causal, hd, s):
    q, k, v, w = _inputs(s, hd, seed=2, h=1)

    def j_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, blk_q=BLK,
                                  blk_k=BLK)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = FA.flash_attention(tq, tk, tv, causal=causal, blk_q=BLK,
                             blk_k=BLK)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    for got, want in zip((tq, tk, tv), j_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,block", [(128, 512), (96, 32), (100, 512)])
def test_blockwise_and_dense_attention_match_jax(causal, s, block):
    q, k, v = _inputs(s, 32, seed=3, n=3)
    j_args = [jnp.asarray(x) for x in (q, k, v)]
    t_args = [_t(x) for x in (q, k, v)]
    np.testing.assert_allclose(
        tattn.blockwise_attention(*t_args, causal=causal,
                                  block_size=block).numpy(),
        np.asarray(jattn.blockwise_attention(*j_args, causal=causal,
                                             block_size=block)), **TOL)
    np.testing.assert_allclose(
        tattn.dense_attention(*t_args, causal=causal).numpy(),
        np.asarray(jattn.dense_attention(*j_args, causal=causal)), **TOL)


def test_unsupported_length_falls_back_and_is_counted_as_in_jax(caplog):
    """S=100 is not a multiple of the default blocks (128, 128): both
    packages take the blockwise path and count it under the same key."""
    assert FA.supported(100, 64) == jfa.supported(100, 64) is False
    assert FA.supported(1024, 64) == jfa.supported(1024, 64) is True
    q, k, v = _inputs(100, 64, seed=4, n=3)
    key = ("flash_attention", 100, 64, 128, 128)
    before = FA.fallback_stats().get(key, 0)
    j_before = jfa.fallback_stats().get(key, 0)
    with caplog.at_level(logging.WARNING, logger="dtg.ops.flash"):
        out = FA.flash_attention(*(_t(x) for x in (q, k, v)), causal=True)
    j_out = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=True)
    assert FA.fallback_stats()[key] == before + 1
    assert jfa.fallback_stats()[key] == j_before + 1
    if before == 0:
        assert any("falling back" in r.message for r in caplog.records)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)


@pytest.mark.parametrize("s", [100, 1000, 1024])
def test_off_the_cpu_every_length_reaches_the_kernels(monkeypatch, s):
    """The block rule is the Pallas kernels' and holds on the CPU only: a
    tensor on another device goes to the kernel wrapper at any S, never to
    the blockwise path. Meta tensors stand in for the card's; the K1
    wrapper is replaced by one that records its call."""
    calls = []

    def fake_fwd(q, k, v, *, scale, causal):
        calls.append((q.shape[1], scale, causal))
        B, S, H, _ = q.shape
        return torch.empty_like(q), torch.empty((B, H, S), device=q.device)

    monkeypatch.setattr(FA, "flash_fwd", fake_fwd)
    q, k, v = (torch.empty(1, s, 2, 64, device="meta") for _ in range(3))
    before = FA.fallback_stats()
    out = FA.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.device.type == "meta"
    assert calls == [(s, 0.125, True)]
    assert FA.fallback_stats() == before


def test_bf16_inputs_stay_within_a_bf16_step_of_f32():
    q, k, v, w = _inputs(128, 64, seed=5)
    f32 = [_t(x).requires_grad_() for x in (q, k, v)]
    b16 = [_t(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out32 = FA.flash_attention(*f32, causal=True, blk_q=BLK, blk_k=BLK)
    out16 = FA.flash_attention(*b16, causal=True, blk_q=BLK, blk_k=BLK)
    assert out16.dtype == torch.bfloat16
    (out32 * _t(w)).sum().backward()
    (out16.float() * _t(w)).sum().backward()
    ref = FA.flash_attention(*(x.detach().bfloat16().float() for x in f32),
                             causal=True, blk_q=BLK, blk_k=BLK)
    torch.testing.assert_close(out16.float(), ref, atol=1e-2, rtol=1e-2)
    for a, b in zip(b16, f32):
        assert a.grad.dtype == torch.bfloat16
        scale = b.grad.abs().max()
        torch.testing.assert_close(a.grad.float() / scale, b.grad / scale,
                                   atol=3e-2, rtol=0)


def test_cpu_calls_leave_the_launch_counts_at_zero():
    FA.reset_launch_counts()
    q, k, v = (_t(x).requires_grad_() for x in _inputs(128, 32, n=3))
    FA.flash_attention(q, k, v, causal=True).sum().backward()
    assert FA.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                           "flash_carry": 0}
    assert q.grad is not None


# ---- K4: the ring carry step -------------------------------------------------


def _pad_lanes(x):
    """(B, S, H, D) numpy -> the JAX kernels' (B, H, S, 128), zero-padded
    head dim."""
    x = np.transpose(x, (0, 2, 1, 3))
    return jnp.asarray(np.pad(x, ((0, 0),) * 3 + ((0, jfa.LANE
                                                   - x.shape[-1]),)))


def _jax_carry_visit(q, k, v, carry, diag):
    """One JAX ``flash_carry_step`` visit in interpret mode from a carry
    given in the port's layout; returns the carry in the port's layout:
    m, l (B, H, S) and acc (B, H, S, D)."""
    m, l, acc = carry
    d = q.shape[-1]
    acc_p = np.pad(acc, ((0, 0),) * 3 + ((0, jfa.LANE - d),))
    jm, jl, jacc = jfa.flash_carry_step(
        _pad_lanes(q), _pad_lanes(k), _pad_lanes(v), _lanes(m), _lanes(l),
        jnp.asarray(acc_p), scale=1.0 / d ** 0.5, diag=diag, blk_q=BLK,
        blk_k=BLK)
    return (np.array(jm[..., 0]), np.array(jl[..., 0]),
            np.array(jacc[..., :d]))


CARRY_CASES = [(diag, start) for diag in (True, False)
               for start in ("fresh", "one_visit")]


@pytest.mark.parametrize("diag,start", CARRY_CASES,
                         ids=[f"{'diag' if d else 'full'}-{s}"
                              for d, s in CARRY_CASES])
def test_plain_carry_step_matches_the_pallas_carry_kernel(diag, start):
    """K4's plain version against JAX ``flash_carry_step`` (Pallas,
    interpret mode): from a fresh carry, and from the carry one earlier
    visit of another KV shard left (the JAX kernel's, handed to both)."""
    q, k, v, k0, v0 = _inputs(128, 32, seed=6, n=5)
    b, s, h, d = q.shape
    fresh = tuple(x.numpy() for x in FA.carry_init(b, h, s, d))
    carry = (fresh if start == "fresh"
             else _jax_carry_visit(q, k0, v0, fresh, diag=False))
    want = _jax_carry_visit(q, k, v, carry, diag)
    got = FA.flash_carry_step_plain(*(_t(x) for x in (q, k, v, *carry)),
                                    1.0 / d ** 0.5, diag)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
    # the wrapper takes the plain version for CPU tensors and counts no
    # launch
    FA.reset_launch_counts()
    again = FA.flash_carry_step(*(_t(x) for x in (q, k, v, *carry)),
                                scale=1.0 / d ** 0.5, diag=diag)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert FA.LAUNCHES["flash_carry"] == 0


def test_carry_finalize_matches_jax():
    """The normaliser after the visits, and a row that saw no key: 0 out,
    and its m (NEG_INF) as its LSE (``safe_l``), as in the JAX package."""
    q, k, v = _inputs(64, 32, seed=7, n=3)
    b, s, h, d = q.shape
    fresh = tuple(x.numpy() for x in FA.carry_init(b, h, s, d))
    m, l, acc = _jax_carry_visit(q, k, v, fresh, diag=True)
    l[:, :, 5] = 0.0  # a row with no visible key
    acc[:, :, 5] = 0.0
    m[:, :, 5] = FA.NEG_INF
    acc_p = np.pad(acc, ((0, 0),) * 3 + ((0, jfa.LANE - d),))
    j_out, j_lse = jfa.carry_finalize(_lanes(m), _lanes(l),
                                      jnp.asarray(acc_p))
    out, lse = FA.carry_finalize(_t(m), _t(l), _t(acc))
    np.testing.assert_allclose(out.numpy(), _bshd(np.asarray(j_out)[..., :d]),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **TOL)
    assert not out[:, 5].any()


def test_a_whole_visit_from_a_fresh_carry_is_the_forward():
    """One diagonal visit of the whole sequence, then the normaliser, is
    K1's plain forward bit for bit (the same code)."""
    q, k, v = (_t(x) for x in _inputs(128, 32, seed=8, n=3))
    b, s, h, d = q.shape
    carry = FA.flash_carry_step_plain(q, k, v, *FA.carry_init(b, h, s, d),
                                      0.25, True)
    out, lse = FA.carry_finalize(*carry)
    want_out, want_lse = FA.flash_fwd_plain(q, k, v, 0.25, True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)


def test_kernel_bounds_count_what_the_path_moves():
    """The bound model at the training path's shape."""
    shape = dict(b=8, h=12, s=1024, d=64)
    assert FA.visible_pairs(8, 12, 1024, True) == 50_380_800
    assert FA.flash_kernel_bytes("flash_fwd", dtype=torch.bfloat16,
                                 **shape) == 4 * 12_582_912 + 393_216
    assert FA.flash_kernel_flops("flash_dkv", causal=True, **shape) == (
        8 * 64 * 50_380_800)
    # K4 at the ring's per-rank shape: q, k, v once, m and l in and out,
    # the f32 acc in and out
    ring = dict(b=4, h=12, s=1024, d=64)
    assert FA.flash_kernel_bytes("flash_carry", dtype=torch.bfloat16,
                                 **ring) == (3 * 6_291_456 + 4 * 196_608
                                             + 2 * 12_582_912)
    assert FA.flash_kernel_flops("flash_carry", causal=False, **ring) == (
        4 * 64 * 4 * 12 * 1024 * 1024)


def test_kernel_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library's cache name hashes its source and every csrc/*.cuh: an
    edited header must not load a stale library."""
    from distributed_tensorflow_guide_tpu_torch.ops import _build

    for name in ("decode_attention", "flash_attention"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "sm90_common.cuh"' in src
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("DTG_TORCH_BUILD_DIR", str(tmp_path / "out"))
    first = _build._target("k")[1]
    assert first.parent == tmp_path / "out"
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert _build._target("k")[1] == first  # stable
    (csrc / "h.cuh").write_text("// two\n")
    second = _build._target("k")[1]
    assert second != first
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("k")[1] not in (first, second)
