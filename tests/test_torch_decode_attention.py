"""Decode attention of the PyTorch port (K5 contiguous, K6 paged) held to
the JAX package's Pallas kernels, which run here in interpret mode.

The same numpy inputs go to both. On the CPU the port's wrappers take
their plain versions; the kernels themselves are held to those plain
versions on the card (``tests/test_torch_kernels_gpu.py`` and
chip_smoke.py).
Tolerance: 1e-5 absolute and relative on float32 outputs — both sides
compute an f32 softmax over the same scores, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.ops import decode_attention as JDA
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA

B, H, S, HD = 2, 3, 64, 16
BS = 8  # pool block size
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _isolated_table(isolated_autotune_table):
    yield


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _both_quantized(x):
    """int8 values and scales from the JAX quantizer, as numpy."""
    x8, sc = JDA.quantize_kv(jnp.asarray(x))
    return np.asarray(x8), np.asarray(sc)


def _cache(seed, quant):
    k, v = _rand(seed, B, H, S, HD), _rand(seed + 1, B, H, S, HD)
    if not quant:
        return k, v, None, None
    k8, ks = _both_quantized(k)
    v8, vs = _both_quantized(v)
    return k8, v8, ks[:, :, None, :], vs[:, :, None, :]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _paged(k, v, ks, vs, seed=11):
    """Scatter (B, H, S, hd) caches into a SHUFFLED pool plus the tables
    that map it back; the pool's extra last block is the trash block."""
    n_blk = S // BS
    perm = np.random.RandomState(seed).permutation(B * n_blk)
    nb = B * n_blk + 1
    kp = np.zeros((nb, H, BS, HD), k.dtype)
    vp = np.zeros_like(kp)
    ksp = np.ones((nb, H, 1, BS), np.float32)
    vsp = np.ones_like(ksp)
    tables = np.zeros((B, n_blk), np.int32)
    for bi in range(B):
        for j in range(n_blk):
            p = int(perm[bi * n_blk + j])
            sl = slice(j * BS, (j + 1) * BS)
            kp[p], vp[p] = k[bi, :, sl], v[bi, :, sl]
            if ks is not None:
                ksp[p, :, 0] = ks[bi, :, 0, sl]
                vsp[p, :, 0] = vs[bi, :, 0, sl]
            tables[bi, j] = p
    if ks is None:
        ksp = vsp = None
    return kp, vp, ksp, vsp, tables


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_plain_k5_matches_jax_kernel(chunk, quant):
    k, v, ks, vs = _cache(1, quant)
    q = _rand(3, B, chunk, H, HD)
    for index in (0, 23, S - chunk):
        want = JDA.decode_attention(_j(q), _j(k), _j(v), index,
                                    key_scale=_j(ks), value_scale=_j(vs),
                                    blk_k=16)
        got = DA.decode_attention(_t(q), _t(k), _t(v), index,
                                  key_scale=_t(ks), value_scale=_t(vs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"index {index}")


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_plain_k6_matches_jax_kernel_through_shuffled_tables(chunk, quant):
    k, v, ks, vs = _cache(5, quant)
    kp, vp, ksp, vsp, tables = _paged(k, v, ks, vs)
    q = _rand(7, B, chunk, H, HD)
    for lengths in ([S, chunk], [chunk + 19, S - 3]):  # ragged
        lens = np.asarray(lengths, np.int32)
        want = JDA.paged_decode_attention(
            _j(q), _j(kp), _j(vp), _j(tables), _j(lens),
            key_scale_pool=_j(ksp), value_scale_pool=_j(vsp),
            block_size=BS, blk_k=8)
        got = DA.paged_decode_attention(
            _t(q), _t(kp), _t(vp), _t(tables), _t(lens),
            key_scale_pool=_t(ksp), value_scale_pool=_t(vsp),
            block_size=BS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"lengths {lengths}")


def test_k6_on_one_block_pool_equals_k5():
    """The paged read of a pool built from a contiguous cache is the
    contiguous read of that cache, request by request."""
    k, v, _, _ = _cache(9, False)
    kp, vp, _, _, tables = _paged(k, v, None, None)
    q = _rand(10, B, 4, H, HD)
    lens = np.asarray([40, 40], np.int32)
    paged = DA.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(lens), block_size=BS)
    flat = DA.decode_attention(_t(q), _t(k), _t(v), 36)
    np.testing.assert_allclose(paged.numpy(), flat.numpy(), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["k5", "k6"])
def test_garbage_beyond_length_cannot_leak(paged):
    """Huge finite garbage in every slot past the live length (what stale
    slots hold) leaves every output bit unchanged."""
    k, v, _, _ = _cache(12, False)
    q = _rand(13, B, 3, H, HD)
    length = 42
    kg, vg = k.copy(), v.copy()
    kg[:, :, length:] = 1e6
    vg[:, :, length:] = -1e6
    if paged:
        lens = _t(np.asarray([length, length], np.int32))
        outs = []
        for kk, vv in ((k, v), (kg, vg)):
            kp, vp, _, _, tables = _paged(kk, vv, None, None)
            outs.append(DA.paged_decode_attention(
                _t(q), _t(kp), _t(vp), _t(tables), lens, block_size=BS))
    else:
        outs = [DA.decode_attention(_t(q), _t(kk), _t(vv), length - 3)
                for kk, vv in ((k, v), (kg, vg))]
    assert torch.equal(outs[0], outs[1])
    want = JDA.decode_attention(_j(q), _j(kg), _j(vg), length - 3,
                                blk_k=16)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(want), **TOL)


def test_idle_slot_length_zero_is_clamped_to_one():
    """An idle engine slot arrives with length 0: the K6 wrapper clamps
    it to 1, as the JAX launcher does, and returns finite values."""
    k, v, _, _ = _cache(14, False)
    kp, vp, _, _, tables = _paged(k, v, None, None)
    q = _rand(15, B, 1, H, HD)
    lens = np.asarray([0, 17], np.int32)
    got = DA.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                    _t(lens), block_size=BS)
    want = JDA.paged_decode_attention(_j(q), _j(kp), _j(vp), _j(tables),
                                      _j(lens), block_size=BS, blk_k=8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantize_kv_matches_jax_bitwise():
    x = _rand(16, 4, 5, 64, scale=3.0)
    x[1, 2] = 0.0  # an all-zero vector: scale 1, never 0/0
    want8, want_sc = _both_quantized(x)
    got8, got_sc = DA.quantize_kv(torch.from_numpy(x))
    assert got8.dtype == torch.int8 and got_sc.dtype == torch.float32
    np.testing.assert_array_equal(got8.numpy(), want8)
    np.testing.assert_array_equal(got_sc.numpy(), want_sc)
    assert got_sc[1, 2] == 1.0


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int8"])
def test_byte_model_matches_jax(name):
    tdt, jdt = getattr(torch, name), getattr(jnp, name)
    assert DA.cache_slot_bytes(64, tdt) == JDA.cache_slot_bytes(64, jdt)
    for eff in (None, 300):
        got = DA.decode_kernel_hbm_bytes(b=8, h=12, s=1024, d=64, dtype=tdt,
                                         chunk=4, effective_len=eff)
        want = JDA.decode_kernel_hbm_bytes(b=8, h=12, s=1024, d=64,
                                           dtype=jdt, chunk=4,
                                           effective_len=eff)
        assert got == want


def test_cpu_tensors_take_the_plain_version_and_others_raise():
    """The CPU is the only place the plain version runs; a tensor on any
    other non-CUDA device raises instead of being routed somewhere."""
    k, v, _, _ = _cache(17, False)
    q = _rand(18, B, 1, H, HD)
    DA.reset_launch_counts()
    DA.decode_attention(_t(q), _t(k), _t(v), 5)
    assert DA.LAUNCHES == {"decode_attention": 0,
                           "paged_decode_attention": 0}
    assert set(DA.REGIME_LAUNCHES.values()) == {0}
    meta = torch.empty(B, 1, H, HD, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        DA.decode_attention(meta, _t(k), _t(v), 5)
    tables = torch.zeros(B, S // BS, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        DA.paged_decode_attention(meta, _t(k), _t(v), tables,
                                  torch.ones(B, dtype=torch.int32),
                                  block_size=BS)



# ---- the split regime's host plan and its plain model ----------------------


@pytest.mark.parametrize("span,want", [(1, 1), (255, 1), (256, 1), (257, 2),
                                       (512, 2), (700, 3), (1024, 4)])
def test_split_count_comes_from_the_span_alone(span, want):
    assert DA.split_count(span) == want
    assert DA.SPLIT_KEYS == 256


def test_split_size_is_fixed_per_cache_dtype_and_head_dim():
    """256 keys a split, 128 where a split's f32 rows would not fit one
    CTA (rows wider than 256 bytes); never a function of the batch."""
    assert DA.split_keys(torch.bfloat16, 128) == 256
    assert DA.split_keys(torch.int8, 128) == 256
    assert DA.split_keys(torch.float32, 64) == 256
    assert DA.split_keys(torch.float32, 80) == 128
    assert DA.split_count(2560, 128) == 20
    assert DA.split_ranges(300, 300, 128) == [(0, 128), (128, 256),
                                              (256, 300)]


def test_split_ranges_cover_each_live_length_once_in_order():
    """Every key below the length lies in exactly one split's range, in
    split order; splits past the length are empty; the count never
    depends on the length (only on the span, K6's table width)."""
    span = 1024
    for length in (1, 2, 255, 256, 257, 511, 700, 1023, 1024):
        ranges = DA.split_ranges(span, length)
        assert len(ranges) == DA.split_count(span)
        keys = [p for lo, hi in ranges for p in range(lo, hi)]
        assert keys == list(range(length))
        assert all(lo == s * DA.SPLIT_KEYS
                   for s, (lo, _) in enumerate(ranges))
        assert all(lo == hi for lo, hi in ranges if lo >= length)
    assert DA.split_ranges(700, 1) == [(0, 1), (256, 256), (512, 512)]


def test_regime_follows_dtype_head_dim_and_chunk_width():
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    t = DA.CHUNK_MIN_ROWS
    assert DA.decode_regime(bf16, bf16, 64, t) == "chunk"
    assert DA.decode_regime(bf16, i8, 64, 512) == "chunk"
    assert DA.decode_regime(bf16, bf16, 64, t - 1) == "split"
    assert DA.decode_regime(bf16, bf16, 64, 1) == "split"
    assert DA.decode_regime(bf16, bf16, 12, 512) == "split"  # hd % 8
    assert DA.decode_regime(f32, f32, 64, 512) == "split"
    assert DA.decode_regime(f32, i8, 64, 512) == "split"


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("chunk,lengths", [
    (1, [1, 1]), (1, [256, 257]), (1, [700, 3]), (5, [5, 600]),
    (16, [512, 513]), (7, [1024, 300])])
def test_split_then_combine_equals_the_one_pass_plain_version(chunk, lengths,
                                                              quant):
    """The split regime's algorithm (per-split partials, empty splits
    included, merged in split order) against the one-pass plain version
    over a 1024-key span: equal within f32 rounding (1e-5)."""
    b, h, s, hd = len(lengths), 2, 1024, 16
    k, v = _rand(31, b, h, s, hd), _rand(32, b, h, s, hd)
    ks = vs = None
    if quant:
        k, ks = _both_quantized(k)
        v, vs = _both_quantized(v)
        ks, vs = _t(ks[:, :, None, :]), _t(vs[:, :, None, :])
    k, v = _t(k), _t(v)
    q = _t(_rand(33, b, chunk, h, hd))
    n = torch.tensor(lengths)
    q_pos = n[:, None] - chunk + torch.arange(chunk)[None, :]
    # what each request may read: keys below its length
    live = torch.arange(s)[None, :] < n[:, None]
    k = torch.where(live[:, None, :, None], k, torch.zeros_like(k))
    want = DA._attend(q, k, v, ks, vs, q_pos)
    got = DA.split_attention_plain(q, k, v, ks, vs, q_pos, s)
    torch.testing.assert_close(got, want, **TOL)
