"""The hand-written decode-attention kernels (K5, K6) and flash-attention
kernels (K1-K4) against their plain PyTorch versions, on CUDA tensors;
and the MoE routing (index dispatch against its one-hot plain version,
the row-invariant router, the MoE engine against its solo generator);
each keys candidate of the tuning table's decode split, and a sweep's
round trip through a temporary table; the generator and the engine fed
CUDA prompts and rngs (bitwise their numpy-fed runs), ``graft_entry``'s
``entry()`` forward (K1 once a layer, within 2**-3 of dense attention)
and ``dryrun_multichip(2)`` in a 2-rank gloo world sharing the card.

Needs the card; each test decides inside itself to skip where there is
none. This file imports neither jax nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_gpu.py

Tolerances: float32 1e-5 for K5/K6 and 1e-4 for K1-K4 (the kernels sum
the same products in another order; a flash output sums up to S products,
a gradient of K3 up to S of them per query tile); bf16 outputs 1e-2, one
bf16 step at |x| < 2 (the kernel rounds an f32 result once, the plain
version after other f32 roundings). The model at a ragged length holds
its flash loss and gradients to the dense path's, float32, at 1e-5
absolute and 1e-4 relative (1000 products per score row summed in other
orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.models import transformer as TF
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as FA
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)
from distributed_tensorflow_guide_tpu_torch.train.hooks import StopAtStepHook
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

TOL = {"f32": 1e-5, "bf16": 1e-2, "int8": 1e-2}


def _cache(kind, b, h, s, hd, gen, dev):
    k = torch.randn(b, h, s, hd, generator=gen, device=dev)
    v = torch.randn(b, h, s, hd, generator=gen, device=dev)
    if kind == "int8":
        k, ks = DA.quantize_kv(k)
        v, vs = DA.quantize_kv(v)
        return k, v, ks[:, :, None].contiguous(), vs[:, :, None].contiguous()
    if kind == "bf16":
        return k.bfloat16(), v.bfloat16(), None, None
    return k, v, None, None


def _pool(x, perm, n_blk, axis):
    """(B, ..., S, ...) cache -> (B * n_blk, ..., S / n_blk, ...) pool whose
    block ``perm[b * n_blk + j]`` holds request b's block j."""
    blocks = x.unflatten(axis, (n_blk, x.shape[axis] // n_blk))
    blocks = torch.movedim(blocks, axis, 1).flatten(0, 1)
    out = torch.empty_like(blocks)
    out[perm.long()] = blocks
    return out.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_kernels_match_plain_versions_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, s, hd, bs = 4, 12, 256, 64, 16
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    tol = dict(atol=TOL[kind], rtol=TOL[kind])
    k, v, ks, vs = _cache(kind, b, h, s, hd, gen, dev)
    n_blk = s // bs
    perm = torch.randperm(b * n_blk, generator=gen, device=dev)
    tables = perm.view(b, n_blk).to(torch.int32)
    kp, vp = _pool(k, perm, n_blk, 2), _pool(v, perm, n_blk, 2)
    ksp = None if ks is None else _pool(ks, perm, n_blk, 3)
    vsp = None if vs is None else _pool(vs, perm, n_blk, 3)
    for c in (1, 7, 64, 200):
        q = torch.randn(b, c, h, hd, generator=gen, device=dev).to(q_dtype)
        index = s - c - 9
        before = dict(DA.LAUNCHES)
        got = DA.decode_attention(q, k, v, index, key_scale=ks,
                                  value_scale=vs)
        want = DA.decode_attention_plain(q, k, v, index, key_scale=ks,
                                         value_scale=vs)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        lens = torch.tensor([s, c, max(c, 100), max(c, 200)],
                            dtype=torch.int32, device=dev)
        got = DA.paged_decode_attention(
            q, kp, vp, tables, lens, key_scale_pool=ksp,
            value_scale_pool=vsp, block_size=bs)
        want = DA.paged_decode_attention_plain(
            q, kp, vp, tables, lens, key_scale_pool=ksp,
            value_scale_pool=vsp, block_size=bs)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert DA.LAUNCHES == {
            "decode_attention": before["decode_attention"] + 1,
            "paged_decode_attention": before["paged_decode_attention"] + 1}


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """A CUDA tensor reaches the kernel or raises; it never runs the plain
    version instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    q = torch.randn(2, 1, 4, 64, device=dev, dtype=torch.bfloat16)
    k = torch.randn(2, 4, 32, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # cache dtype differs from q's
        DA.decode_attention(q, k.float(), k.float(), 3)
    with pytest.raises(ValueError):  # int8 cache without its scales
        DA.decode_attention(q, k.to(torch.int8), k.to(torch.int8), 3)
    with pytest.raises(ValueError):  # the chunk ends past the cache
        DA.decode_attention(q, k, k, 32)
    with pytest.raises(ValueError):  # scales of the wrong shape
        k8, sc = DA.quantize_kv(k)
        DA.decode_attention(q, k8, k8, 3, key_scale=sc, value_scale=sc)
    with pytest.raises(ValueError):  # tables must be int32
        DA.paged_decode_attention(
            q, k, k, torch.zeros(2, 1, dtype=torch.int64, device=dev),
            torch.ones(2, dtype=torch.int32, device=dev), block_size=32)
    wide_q = torch.randn(2, 1, 4, 136, device=dev, dtype=torch.bfloat16)
    wide_k = torch.randn(2, 4, 32, 136, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim above MAX_HEAD_DIM
        DA.decode_attention(wide_q, wide_k, wide_k, 3)


def _nan_past(x, lengths, axis):
    """A copy of a (B, H, S, ...) cache with garbage at every position at
    or past each request's length along ``axis`` (2 for K/V, 3 for
    scales): NaN, or 127 in an int8 cache (whose scales get the NaN)."""
    x = x.clone()
    fill = 127 if x.dtype == torch.int8 else float("nan")
    for b, n in enumerate(lengths):
        x[b].narrow(axis - 1, n, x.shape[axis] - n).fill_(fill)
    return x


DECODE_C = (1, 2, 7, 9, 10, 16, 63, 64, 65, 128, 200, 512)
DECODE_S = 640  # past two split edges (256, 512)


def _decode_lengths(C):
    """Live lengths of the sweep: 1, C, split and block edges +-1, S."""
    edges = {1, C, DECODE_S}
    for e in (8, 16, 32, 64, 256, 512):
        edges |= {e - 1, e, e + 1}
    return sorted(n for n in edges if C <= n <= DECODE_S)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [12, 32, 64, 80, 128])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("C", DECODE_C)
def test_decode_edge_sweep_on_the_card(C, kind, hd):
    """K5 and K6 at the edges of both regimes (split-KV below
    ``CHUNK_MIN_ROWS`` rows and for f32 or a head dim off a multiple of 8,
    tensor cores from it on): C across the threshold (9, 10) and the
    64-row tiles, live lengths of 1, C,
    split and block edges +-1 and S, block sizes 8, 16 and 32, head dims
    12 to 128; each against its plain version (tolerances of the first
    test), bitwise equal on a repeat. NaN written past every length and
    into K6's trash block must not reach the output; a K6 request gives
    the same bits alone at B=1 as among its batch-mates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11 + C + hd)
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    tol = dict(atol=TOL[kind], rtol=TOL[kind])
    h, S = 2, DECODE_S
    lengths = _decode_lengths(C)

    # K5: one call per length, two requests
    b = 2
    k, v, ks, vs = _cache(kind, b, h, S, hd, gen, dev)
    for n in lengths:
        q = torch.randn(b, C, h, hd, generator=gen, device=dev).to(q_dtype)
        want = DA.decode_attention_plain(q, k, v, n - C, key_scale=ks,
                                         value_scale=vs)
        dirty = [_nan_past(t, [n] * b, ax) if t is not None else None
                 for t, ax in ((k, 2), (v, 2), (ks, 3), (vs, 3))]
        got = DA.decode_attention(q, dirty[0], dirty[1], n - C,
                                  key_scale=dirty[2], value_scale=dirty[3])
        again = DA.decode_attention(q, dirty[0], dirty[1], n - C,
                                    key_scale=dirty[2], value_scale=dirty[3])
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=f"K5 length {n}")
        assert torch.equal(got, again), f"K5 length {n} not repeatable"

    # K6: eight requests at lengths from the sweep, shuffled pool
    b = 8
    lens = [lengths[i % len(lengths)] for i in range(b)]
    k, v, ks, vs = _cache(kind, b, h, S, hd, gen, dev)
    q = torch.randn(b, C, h, hd, generator=gen, device=dev).to(q_dtype)
    for bs in (8, 16, 32):
        n_blk = S // bs
        perm = torch.randperm(b * n_blk, generator=gen, device=dev)
        tables = perm.view(b, n_blk).to(torch.int32)
        trash = b * n_blk
        for i, n in enumerate(lens):  # blocks past the length: the trash
            tables[i, -(-n // bs):] = trash

        def pool(x, axis, fill):
            p = _pool(x, perm, n_blk, axis)
            tail = torch.full_like(p[:1], fill)
            return torch.cat([p, tail]).contiguous()

        clean = [pool(t, ax, 0.0) if t is not None else None
                 for t, ax in ((k, 2), (v, 2), (ks, 3), (vs, 3))]
        dirty = [pool(_nan_past(t, lens, ax), ax,
                      127 if t.dtype == torch.int8 else float("nan"))
                 if t is not None else None
                 for t, ax in ((k, 2), (v, 2), (ks, 3), (vs, 3))]
        lengths_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(key_scale_pool=dirty[2], value_scale_pool=dirty[3],
                  block_size=bs)
        want = DA.paged_decode_attention_plain(
            q, clean[0], clean[1], tables, lengths_t,
            key_scale_pool=clean[2], value_scale_pool=clean[3],
            block_size=bs)
        got = DA.paged_decode_attention(q, dirty[0], dirty[1], tables,
                                        lengths_t, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=f"K6 block size {bs}")
        assert torch.equal(got, DA.paged_decode_attention(
            q, dirty[0], dirty[1], tables, lengths_t, **kw))
        for i in (0, b - 1):
            alone = DA.paged_decode_attention(
                q[i:i + 1], dirty[0], dirty[1], tables[i:i + 1].clone(),
                lengths_t[i:i + 1].clone(), **kw)
            assert torch.equal(alone[0], got[i]), f"request {i} alone"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_decode_over_many_splits_on_the_card(kind):
    """A 2560-key span (10 splits; 20 for f32 rows of 128): the partials
    go through the workspace and the combine kernel in split order;
    against the plain versions, bitwise repeatable. hd = 128 covers the
    f32 route's 128-key splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    b, h, s, hd, bs = 2, 3, 2560, 128, 16
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    tol = dict(atol=TOL[kind], rtol=TOL[kind])
    k, v, ks, vs = _cache(kind, b, h, s, hd, gen, dev)
    n_blk = s // bs
    perm = torch.randperm(b * n_blk, generator=gen, device=dev)
    tables = perm.view(b, n_blk).to(torch.int32)
    kp, vp = _pool(k, perm, n_blk, 2), _pool(v, perm, n_blk, 2)
    ksp = None if ks is None else _pool(ks, perm, n_blk, 3)
    vsp = None if vs is None else _pool(vs, perm, n_blk, 3)
    for c in (1, 5):
        q = torch.randn(b, c, h, hd, generator=gen, device=dev).to(q_dtype)
        got = DA.decode_attention(q, k, v, 2400 - c, key_scale=ks,
                                  value_scale=vs)
        want = DA.decode_attention_plain(q, k, v, 2400 - c, key_scale=ks,
                                         value_scale=vs)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(got, DA.decode_attention(
            q, k, v, 2400 - c, key_scale=ks, value_scale=vs))
        lens = torch.tensor([s, 300], dtype=torch.int32, device=dev)
        kw = dict(key_scale_pool=ksp, value_scale_pool=vsp, block_size=bs)
        got = DA.paged_decode_attention(q, kp, vp, tables, lens, **kw)
        want = DA.paged_decode_attention_plain(q, kp, vp, tables, lens, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_decode_regime_named_by_the_caller_on_the_card(kind):
    """K6 in either regime at chunk widths on both sides of the threshold
    (what the threshold's measurement runs): each against the plain
    version, one wrapper launch and one launch of its regime a call. The
    chunk regime refuses a head dim off a multiple of 8, and the kernels'
    entry point refuses a split plan that does not cover the span or
    whose split is wider than a CTA's lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31)
    b, h, s, hd, bs = 3, 2, 640, 64, 16
    tol = dict(atol=TOL[kind], rtol=TOL[kind])
    k, v, ks, vs = _cache(kind, b, h, s, hd, gen, dev)
    n_blk = s // bs
    perm = torch.randperm(b * n_blk, generator=gen, device=dev)
    tables = perm.view(b, n_blk).to(torch.int32)
    kp, vp = _pool(k, perm, n_blk, 2), _pool(v, perm, n_blk, 2)
    kw = dict(key_scale_pool=None if ks is None else _pool(ks, perm, n_blk, 3),
              value_scale_pool=None if vs is None else _pool(vs, perm,
                                                             n_blk, 3),
              block_size=bs)
    for c in (1, 4, 16, 128):
        q = torch.randn(b, c, h, hd, generator=gen,
                        device=dev).bfloat16()
        lens = torch.tensor([s, c, 300], dtype=torch.int32, device=dev)
        want = DA.paged_decode_attention_plain(q, kp, vp, tables, lens, **kw)
        for regime in ("split", "chunk"):
            before = dict(DA.REGIME_LAUNCHES)
            calls = DA.LAUNCHES["paged_decode_attention"]
            got = DA.paged_decode_attention_kernel(
                q, kp, vp, tables, lens, regime=regime, **kw)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            name = f"paged_decode_attention.{regime}"
            assert DA.REGIME_LAUNCHES == {**before, name: before[name] + 1}
            assert DA.LAUNCHES["paged_decode_attention"] == calls + 1
    q12 = torch.randn(b, 16, h, 16, generator=gen, device=dev).bfloat16()
    q12 = q12[..., :12].contiguous()
    k12 = torch.zeros(b * n_blk, h, bs, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        DA.paged_decode_attention_kernel(q12, k12, k12, tables, lens,
                                         block_size=bs, regime="chunk")
    if kind == "bf16":
        out = torch.empty_like(q)
        for n_splits, keys in ((1, 256), (3, 264)):  # 256 < 640; 264 > 256
            rc = DA._lib().dtg_paged_decode_attention(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
                tables.data_ptr(), lens.data_ptr(), out.data_ptr(), None,
                b, q.shape[1], h, hd, bs, n_blk, 1, 1, 1.0 / hd ** 0.5,
                n_splits, keys, torch.cuda.current_stream().cuda_stream)
            assert rc != 0


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_every_split_keys_candidate_matches_the_plain_split_on_the_card(
        kind, hd):
    """Each keys candidate of the tuning table's ``decode_split`` entry
    (64, 128, 256; 64 and 128 for f32 rows of 128): K5 and K6 decode
    steps (C = 1) through the kernels against ``split_attention_plain``
    with the same keys on the same operands, and a 5-row chunk of K5
    against the one-pass plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.ops import autotune

    dev = torch.device("cuda", 0)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[kind]
    tol = dict(atol=TOL[kind], rtol=TOL[kind])
    cands = autotune.split_keys_candidates(hd, dtype, 16)
    assert cands == ([64, 128] if kind == "f32" and hd == 128
                     else [64, 128, 256])
    r = DA.make_split_runners(b=4, h=12, s=640, d=hd, dtype=dtype,
                              block_size=16, device=dev, seed=41)
    gen = torch.Generator(device=dev).manual_seed(42)
    k, v, ks, vs = _cache(kind, 2, 3, 640, hd, gen, dev)
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn(2, 5, 3, hd, generator=gen, device=dev).to(q_dtype)
    want = DA.decode_attention_plain(q, k, v, 300, key_scale=ks,
                                     value_scale=vs)
    for keys in cands:
        torch.testing.assert_close(r.k5(keys).float(),
                                   r.k5_plain(keys).float(), **tol)
        torch.testing.assert_close(r.k6(keys).float(),
                                   r.k6_plain(keys).float(), **tol)
        got = DA.decode_attention(q, k, v, 300, key_scale=ks,
                                  value_scale=vs, split_keys=keys)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    with pytest.raises(ValueError, match="split_keys"):
        DA.decode_attention(q, k, v, 300, key_scale=ks, value_scale=vs,
                            split_keys=100)


@pytest.mark.gpu
def test_split_sweep_round_trip_on_the_card(tmp_path, monkeypatch):
    """A sweep of K5 + K6 on the card records a candidate in a temporary
    table with no failure; after ``reset()`` the online front door finds
    it and makes no attempt."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.ops import autotune

    monkeypatch.setenv("DTG_AUTOTUNE_TABLE", str(tmp_path / "table.json"))
    autotune.reset()
    try:
        kw = dict(h=12, d=64, dtype=torch.bfloat16, device="cuda")
        shape = dict(b=8, s=1024, block_size=16)
        keys = autotune.ensure_split_keys_tuned(iters=5, **kw, **shape)
        assert keys in autotune.split_keys_candidates(64, torch.bfloat16)
        assert autotune.online_tune_stats()["failed"] == 0
        assert (tmp_path / "table.json").exists()
        autotune.reset()
        autotune.set_online_tune(True)
        got = autotune.ensure_tuned_online(autotune.DECODE_SPLIT_KERNEL,
                                           shape=shape, **kw)
        assert got == keys
        assert autotune.online_tune_stats()["attempted"] == 0
    finally:
        autotune.reset()


FLASH_TOL = {"f32": 1e-4, "bf16": 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_flash_kernels_match_plain_versions_on_the_card(kind, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    tol = dict(atol=FLASH_TOL[kind], rtol=FLASH_TOL[kind])
    for b, s, h, hd in ((2, 128, 3, 64), (1, 200, 2, 40), (2, 77, 2, 128)):
        q, k, v, do = (torch.randn(b, s, h, hd, generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        scale = hd ** -0.5
        before = dict(FA.LAUNCHES)
        out, lse = FA.flash_fwd(q, k, v, scale=scale, causal=causal)
        ref, ref_lse = FA.flash_fwd_plain(q, k, v, scale, causal)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
        delta = (do.float() * ref.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, do, ref_lse, delta.contiguous())
        dq = FA.flash_bwd_dq(*args, scale=scale, causal=causal)
        dk, dv = FA.flash_bwd_dkv(*args, scale=scale, causal=causal)
        torch.testing.assert_close(
            dq.float(), FA.flash_bwd_dq_plain(*args, scale, causal).float(),
            **tol)
        rk, rv = FA.flash_bwd_dkv_plain(*args, scale, causal)
        torch.testing.assert_close(dk.float(), rk.float(), **tol)
        torch.testing.assert_close(dv.float(), rv.float(), **tol)
        # one CTA owns each output tile: bitwise repeatable
        assert torch.equal(dq, FA.flash_bwd_dq(*args, scale=scale,
                                               causal=causal))
        dk2, dv2 = FA.flash_bwd_dkv(*args, scale=scale, causal=causal)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
        assert FA.LAUNCHES == {"flash_fwd": before["flash_fwd"] + 1,
                               "flash_dq": before["flash_dq"] + 2,
                               "flash_dkv": before["flash_dkv"] + 2,
                               "flash_carry": before["flash_carry"]}


SWEEP_S = (1, 17, 63, 64, 65, 127, 128, 129, 192, 1000, 1024, 2048)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [8, 40, 64, 72, 128])
@pytest.mark.parametrize("S", SWEEP_S)
def test_flash_forward_edge_sweep_on_the_card(S, hd, causal):
    """The bf16 forward template at the edges of its tiling: K1 on q, k, v
    read in place as column slices of one (B, S, 3 * H * hd) tensor, and
    K4 as two visits into one carry (a fresh full visit, then one masked
    like the call), in place; both against their plain versions. S covers
    fewer KV tiles than pipeline stages and ragged last query and KV
    tiles; hd = 8, 40, 72 are zero-padded to the 64 or 128 columns of the
    kernel's tiles; S = 1024 runs at B=8, H=12, more than one wave of
    CTAs. K1 must give bitwise-equal outputs on a repeat. Tolerances as
    in the tests above: bf16 outputs 1e-2, LSE and m 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5 + S + hd)
    b, h = (8, 12) if S == 1024 else (2, 3)
    scale = hd ** -0.5
    qkv = torch.randn(b, S, 3 * h * hd, generator=gen,
                      device=dev).bfloat16()
    q, k, v = qkv.view(b, S, 3, h, hd).unbind(2)
    before = dict(FA.LAUNCHES)
    out, lse = FA.flash_fwd(q, k, v, scale=scale, causal=causal)
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, scale, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    out2, lse2 = FA.flash_fwd(q, k, v, scale=scale, causal=causal)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)

    k1, v1 = (t.contiguous() for t in (k, v))
    k0, v0 = (torch.randn(b, S, h, hd, generator=gen, device=dev).bfloat16()
              for _ in range(2))
    qc = q.contiguous()
    carry = FA.carry_init(b, h, S, hd, device=dev)
    want = tuple(t.clone() for t in carry)
    for kk, vv, d in ((k0, v0, False), (k1, v1, causal)):
        got = FA.flash_carry_step(qc, kk, vv, *carry, scale=scale, diag=d)
        assert all(x is y for x, y in zip(got, carry))  # in place
        want = FA.flash_carry_step_plain(qc, kk, vv, *want, scale, d)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {**before,
                           "flash_fwd": before["flash_fwd"] + 2,
                           "flash_carry": before["flash_carry"] + 2}
    torch.testing.assert_close(carry[0], want[0], atol=1e-4, rtol=1e-5)
    for got_t, want_t in zip(carry[1:], want[1:]):
        top = want_t.abs().amax()
        torch.testing.assert_close(got_t / top, want_t / top, atol=1e-2,
                                   rtol=0)
    got_out, got_lse = FA.carry_finalize(*carry)
    ref_out, ref_lse = FA.carry_finalize(*want)
    torch.testing.assert_close(got_out, ref_out, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got_lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [8, 40, 64, 72, 128])
@pytest.mark.parametrize("S", SWEEP_S)
def test_flash_backward_edge_sweep_on_the_card(S, hd, causal):
    """The bf16 backward kernels K2 (dQ) and K3 (dK, dV) at the edges of
    their tiling, on q, k, v read in place as column slices of one
    (B, S, 3 * H * hd) tensor, from the plain forward's LSE and delta:
    against their plain versions at 1e-2 (one bf16 step) relative to the
    larger of the reference's largest entry and 1: a gradient sums up to
    S rounded dS products, so its small entries carry the large ones'
    rounding, as K4's acc in the sweep above, and where the reference is
    below 1 the bound is the 1e-2 absolute of the test above (at S = 1 dQ
    is cancellation noise: one key, so dP - delta is 0 in exact
    arithmetic); bitwise equal on a repeat; one launch of each per call.
    S covers fewer tiles than pipeline stages, ragged last query and key
    tiles and, at S = 1024 (B=8, H=12), more than one wave of CTAs;
    hd = 8, 40, 72 are zero-padded to 64 or 128 columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7 + S + hd)
    b, h = (8, 12) if S == 1024 else (2, 3)
    scale = hd ** -0.5
    qkv = torch.randn(b, S, 3 * h * hd, generator=gen,
                      device=dev).bfloat16()
    q, k, v = qkv.view(b, S, 3, h, hd).unbind(2)
    do = torch.randn(b, S, h, hd, generator=gen, device=dev).bfloat16()
    out, lse = FA.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    kw = dict(scale=scale, causal=causal)
    before = dict(FA.LAUNCHES)
    dq = FA.flash_bwd_dq(*args, **kw)
    dk, dv = FA.flash_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {**before, "flash_dq": before["flash_dq"] + 1,
                           "flash_dkv": before["flash_dkv"] + 1}
    want = (FA.flash_bwd_dq_plain(*args, scale, causal),
            *FA.flash_bwd_dkv_plain(*args, scale, causal))
    for name, got_t, want_t in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        top = want_t.float().abs().amax().clamp_min(1.0)
        torch.testing.assert_close(got_t.float() / top, want_t.float() / top,
                                   atol=1e-2, rtol=0, msg=name)
    dk2, dv2 = FA.flash_bwd_dkv(*args, **kw)
    assert torch.equal(dq, FA.flash_bwd_dq(*args, **kw))
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.gpu
def test_flash_attention_on_qkv_slices_matches_the_cpu_path():
    """The autograd Function on column slices of one qkv tensor (the
    layout the model hands it, read in place by the kernels) against the
    same call on the CPU, which runs the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(2)
    qkv = torch.randn(2, 256, 3, 4, 64, generator=gen)
    w = torch.randn(2, 256, 4, 64, generator=gen)
    grads = []
    for dev in ("cpu", "cuda"):
        x = qkv.to(dev).clone().requires_grad_()
        out = FA.flash_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2],
                                 causal=True, blk_q=128, blk_k=128)
        (out * w.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), x.grad.cpu()))
    (o_cpu, g_cpu), (o_gpu, g_gpu) = grads
    torch.testing.assert_close(o_gpu, o_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(g_gpu, g_cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(TypeError):  # float16 is not taken
        FA.flash_fwd(q.half(), q.half(), q.half(), scale=0.125, causal=True)
    with pytest.raises(TypeError):  # mixed dtypes
        FA.flash_fwd(q, q.bfloat16(), q, scale=0.125, causal=True)
    # a head dim off a multiple of 8 is zero-padded and served
    odd = torch.randn(1, 64, 2, 12, device=dev)
    out, lse = FA.flash_fwd(odd, odd, odd, scale=0.3, causal=True)
    ref, ref_lse = FA.flash_fwd_plain(odd, odd, odd, 0.3, True)
    assert out.shape == odd.shape
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    wide = torch.randn(1, 64, 2, 136, device=dev)
    with pytest.raises(ValueError):  # head dim above 128
        FA.flash_fwd(wide, wide, wide, scale=0.1, causal=True)
    with pytest.raises(ValueError):  # the same for the bf16 kernel
        FA.flash_fwd(wide.bfloat16(), wide.bfloat16(), wide.bfloat16(),
                     scale=0.1, causal=True)
    # contiguous, but starting 2 bytes past a 16-byte boundary: the
    # wrapper hands the kernels a fresh aligned copy
    flat = torch.randn(1 * 64 * 2 * 64 + 1, device=dev).bfloat16()
    off = flat[1:].view(1, 64, 2, 64)
    assert off.is_contiguous() and off.data_ptr() % 16
    out, lse = FA.flash_fwd(off, off, off, scale=0.125, causal=True)
    ref, ref_lse = FA.flash_fwd_plain(off, off, off, 0.125, True)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    m, l, acc = FA.carry_init(1, 2, 64, 64, device=dev)
    want = FA.flash_carry_step_plain(off, off, off, m, l, acc, 0.125, True)
    FA.flash_carry_step(off, off, off, m, l, acc, scale=0.125, diag=True)
    torch.testing.assert_close(m, want[0], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(acc / want[2].abs().amax(),
                               want[2] / want[2].abs().amax(), atol=1e-2,
                               rtol=0)
    lse = torch.zeros(1, 2, 63, device=dev)
    with pytest.raises(ValueError):  # lse of the wrong shape
        FA.flash_bwd_dq(q, q, q, q, lse, lse, scale=0.125, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("hd", [12, 32, 80])
def test_flash_kernels_at_head_dims_the_reference_takes(hd, kind, causal):
    """K1-K4 at the head dims of the JAX package's flash tests (12 is off
    a multiple of 8: the wrappers zero-pad it to 16 and slice back; the
    scale stays 1/sqrt(hd)), through the autograd call and the carry
    step, against the plain versions at the tolerances above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(hd)
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    tol = FLASH_TOL[kind]
    b, s, h = 2, 200, 3
    q, k, v, w = (torch.randn(b, s, h, hd, generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    scale = hd ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(FA.LAUNCHES)
    out = FA.flash_attention(*leaves, causal=causal)
    out.backward(w)
    assert FA.LAUNCHES == {**before, "flash_fwd": before["flash_fwd"] + 1,
                           "flash_dq": before["flash_dq"] + 1,
                           "flash_dkv": before["flash_dkv"] + 1}
    ref, ref_lse = FA.flash_fwd_plain(q, k, v, scale, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    delta = (w.float() * out.detach().float()).sum(-1).transpose(1, 2)
    _, lse = FA.flash_fwd(q, k, v, scale=scale, causal=causal)
    args = (q, k, v, w, lse, delta.contiguous())
    want = (FA.flash_bwd_dq_plain(*args, scale, causal),
            *FA.flash_bwd_dkv_plain(*args, scale, causal))
    for name, leaf, want_t in zip("qkv", leaves, want):
        assert leaf.grad.shape == (b, s, h, hd)
        top = want_t.float().abs().amax().clamp_min(1.0)
        torch.testing.assert_close(leaf.grad.float() / top,
                                   want_t.float() / top, atol=tol, rtol=0,
                                   msg=f"d{name}")
    m, l, acc = FA.carry_init(b, h, s, hd, device=dev)
    want = FA.flash_carry_step_plain(q, k, v, m, l, acc, scale, causal)
    got = FA.flash_carry_step(q, k, v, m, l, acc, scale=scale, diag=causal)
    assert got[2] is acc and acc.shape == (b, h, s, hd)
    got_out, _ = FA.carry_finalize(*got)
    ref_out, _ = FA.carry_finalize(*want)
    torch.testing.assert_close(got_out, ref_out, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_the_model_refuses_a_head_dim_above_the_limit_on_the_card():
    """hd = 136 > MAX_HEAD_DIM: the CPU model is built, and moving it to
    the card raises there, naming the limit, before any weight moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TF.TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                               d_model=272, d_ff=64, max_len=32,
                               dtype=torch.bfloat16)
    model = TF.Transformer(cfg).init_weights(0)
    with pytest.raises(ValueError, match="up to 128"):
        model.to("cuda")
    assert model.device.type == "cpu"


@pytest.mark.gpu
def test_the_model_trains_through_the_kernels_at_a_ragged_length():
    """``attn_impl="flash"`` at S=1000, no multiple of the JAX package's
    block pair: on the card each layer launches K1, K2 and K3 once a step,
    nothing falls back to the blockwise path, and one step's loss and
    gradients agree with the dense attention path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TF.TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                               d_model=128, d_ff=256, max_len=1024,
                               dtype=torch.float32, attn_impl="flash")
    model = TF.Transformer(cfg).init_weights(0).to("cuda")
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, 256, (2, 1000), generator=gen)}
    loss_fn = TF.make_lm_loss_fn(model)
    before = FA.fallback_stats()

    on_card = {"tokens": batch["tokens"].cuda()}
    (loss, _), grads = value_and_grad(loss_fn, model, on_card)
    dense = model.with_config(dataclasses.replace(cfg, attn_impl="dense"))
    (want_loss, _), want = value_and_grad(loss_fn, dense, on_card)
    torch.testing.assert_close(loss, want_loss, atol=1e-5, rtol=1e-4)
    for n in want:
        torch.testing.assert_close(grads[n], want[n], atol=1e-5, rtol=1e-4,
                                   msg=n)

    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    FA.reset_launch_counts()
    TrainLoop(DataParallel().make_train_step(loss_fn), state,
              iter(lambda: batch, None), hooks=[StopAtStepHook(2)]).run()
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_fwd": 2 * cfg.num_layers,
                           "flash_dq": 2 * cfg.num_layers,
                           "flash_dkv": 2 * cfg.num_layers,
                           "flash_carry": 0}
    assert FA.fallback_stats() == before


@pytest.mark.gpu
@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_carry_kernel_matches_its_plain_version_on_the_card(kind, diag):
    """K4 at the ring's per-rank shape (B=4, H=12, hd=64) and at a ragged
    S_loc = 1000: two visits in a row (a fresh carry, then the carry the
    first one left), in place, against the plain version; the normalised
    output at 1e-4 (f32) or 1e-2 (bf16), the carry's running max m at
    1e-4 (the LSE's bound in the K1 test: score sums in another order) and
    l, acc relative to their largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    tol = FLASH_TOL[kind]
    for s in (1024, 1000):
        b, h, hd = 4, 12, 64
        q, k0, v0, k1, v1 = (torch.randn(b, s, h, hd, generator=gen,
                                         device=dev).to(dtype)
                             for _ in range(5))
        scale = hd ** -0.5
        carry = FA.carry_init(b, h, s, hd, device=dev)
        want = tuple(t.clone() for t in carry)
        before = FA.LAUNCHES["flash_carry"]
        for kk, vv, d in ((k0, v0, False), (k1, v1, diag)):
            got = FA.flash_carry_step(q, kk, vv, *carry, scale=scale, diag=d)
            assert all(a is b for a, b in zip(got, carry))  # in place
            want = FA.flash_carry_step_plain(q, kk, vv, *want, scale, d)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_carry"] == before + 2
        torch.testing.assert_close(carry[0], want[0], atol=1e-4, rtol=1e-5)
        for got_t, want_t in zip(carry[1:], want[1:]):
            torch.testing.assert_close(got_t / want_t.abs().amax(),
                                       want_t / want_t.abs().amax(),
                                       atol=tol, rtol=0)
        out, lse = FA.carry_finalize(*carry)
        ref, ref_lse = FA.carry_finalize(*want)
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
def test_carry_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    q = torch.randn(1, 64, 2, 64, device=dev)
    m, l, acc = FA.carry_init(1, 2, 64, 64, device=dev)
    with pytest.raises(ValueError):  # a carry of the wrong length
        FA.flash_carry_step(q, q, q, m[:, :, :32].contiguous(), l, acc,
                            scale=0.125, diag=True)
    with pytest.raises(ValueError):  # acc not f32
        FA.flash_carry_step(q, q, q, m, l, acc.bfloat16(), scale=0.125,
                            diag=True)
    with pytest.raises(ValueError):  # a carry on the CPU
        FA.flash_carry_step(q, q, q, m.cpu(), l, acc, scale=0.125,
                            diag=True)


@pytest.mark.gpu
def test_two_rank_1f1b_step_runs_the_flash_kernels_and_matches_one_process():
    """A pipe = 2 1F1B step on the card (both ranks on ``cuda:0`` over
    gloo) launches K1 twice a layer and microbatch on the first stage (the
    recompute) and once on the last, which runs its chunk only on the
    backward tick, and K2, K3 once, with no fallback; its loss and
    gathered gradients agree with the single-process step on the same
    weights and batch (bf16: relative norm of each gradient's difference
    within 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.runtime.multiprocess import (
        run_multiprocess,
    )
    from tests import torch_mp_workers as W

    res = [r.result for r in run_multiprocess(
        "tests.torch_mp_workers:pipeline_gpu_rank", 2, timeout=600)]
    cfg = TF.TransformerConfig(**W.PP_GPU_GEOM, dtype=torch.bfloat16)
    model = TF.Transformer(cfg).init_weights(0).to("cuda")
    (loss, _), grads = value_and_grad(
        TF.make_lm_loss_fn(model), model,
        {"tokens": torch.as_tensor(W.pp_gpu_tokens(), device="cuda")})
    for r in res:
        n = r["layers"] * W.PP_GPU_M
        fwd = n if r["last_stage"] else 2 * n
        assert r["launches"] == {"flash_fwd": fwd, "flash_dq": n,
                                 "flash_dkv": n, "flash_carry": 0}
        assert r["fallbacks"] == 0
        assert abs(r["loss"] - loss.item()) < 1e-2
    for name, g in grads.items():
        got = torch.as_tensor(res[0][f"grad/{name}"], device="cuda")
        gap = (got - g.float()).norm() / g.float().norm().clamp_min(1e-30)
        assert gap.item() < 2e-2, (name, gap.item())


# ---- the device-index K5 and the captured serving steps (CUDA graphs) ----


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("C", [1, 5, 64, 130])
def test_k5_device_index_replays_and_hides_garbage_on_the_card(C, kind):
    """K5 with its write index in device memory: a tensor index gives the
    bits of an int index; NaN, and then 3e38, written past the live
    length change no bit of the output (the chunk regime's TMA map covers
    all S rows, so the tile the length crosses is gathered with zeros);
    an index out of range is clamped as the plain version clamps it;
    one call captured in a CUDA graph over a static index and replayed at
    four indices gives the bits of four eager calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31 + C)
    b, h, S, hd = 2, 3, 640, 64
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    k, v, ks, vs = _cache(kind, b, h, S, hd, gen, dev)
    q = torch.randn(b, C, h, hd, generator=gen, device=dev).to(q_dtype)
    kw = dict(key_scale=ks, value_scale=vs)
    indices = (0, 200, 511 - C + 1, S - C)
    for index in indices:
        n = index + C
        want = DA.decode_attention(q, k, v, index, **kw)
        idx = torch.tensor([index], dtype=torch.int32, device=dev)
        assert torch.equal(DA.decode_attention(q, k, v, idx, **kw), want)
        torch.testing.assert_close(
            want.float(), DA.decode_attention_plain(q, k, v, idx,
                                                    **kw).float(),
            atol=TOL[kind], rtol=TOL[kind])
        for garbage in (float("nan"), 3e38):
            dirty = []
            for t, ax in ((k, 2), (v, 2), (ks, 3), (vs, 3)):
                if t is not None:
                    t = t.clone()
                    t.narrow(ax, n, S - n).fill_(
                        127 if t.dtype == torch.int8 else garbage)
                dirty.append(t)
            got = DA.decode_attention(q, dirty[0], dirty[1], idx,
                                      key_scale=dirty[2],
                                      value_scale=dirty[3])
            assert torch.equal(got, want), (index, garbage)
    # a device index out of range: the kernel clamps the live length to
    # [1, S] as the plain version does
    for wild, same in ((S - C + 9, S - C),) + (((-40, 0),) if C == 1
                                                else ()):
        idx = torch.tensor([wild], dtype=torch.int32, device=dev)
        got = DA.decode_attention(q, k, v, idx, **kw)
        assert torch.equal(got, DA.decode_attention(q, k, v, same, **kw))
        torch.testing.assert_close(
            got.float(), DA.decode_attention_plain(q, k, v, idx,
                                                   **kw).float(),
            atol=TOL[kind], rtol=TOL[kind])
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    DA.decode_attention(q, k, v, idx, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DA.decode_attention(q, k, v, idx, **kw)
    for index in indices:
        idx.fill_(index)
        graph.replay()
        assert torch.equal(out, DA.decode_attention(q, k, v, index, **kw))


def _small_lm(**kw):
    """GPT-2 124M's widths at 4 layers, bf16: the widths at which cuBLAS's
    GEMMs were measured to give each row the bits of a one-row product,
    which the bitwise comparisons of differently batched runs rest on."""
    cfg = dataclasses.replace(TF.gpt2_124m(dtype=torch.bfloat16, **kw),
                              num_layers=4, max_len=256)
    return cfg, TF.Transformer(cfg).init_weights(0).to("cuda")


def _engine_streams(eng, prompts, max_new, adapters=None, rid0=0):
    from distributed_tensorflow_guide_tpu_torch.serve.engine import Request

    for i, p in enumerate(prompts):
        eng.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=max_new,
                           rng=torch.tensor([0, 50 + i]).numpy(),
                           adapter=0 if adapters is None else adapters[i]))
    eng.run()
    eng.sched.pool.check_leaks()
    return {rid - rid0: t for rid, t in eng.completions().items()
            if rid >= rid0}


@pytest.mark.gpu
@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_captured_engine_steps_equal_eager_steps_on_the_card(temp, top_k):
    """The engine's decode and prefill steps replayed from their CUDA
    graphs give the eager steps' streams bitwise, with one capture a graph
    over the engine's life and K6 counted once a layer a step through the
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
    )

    cfg, model = _small_lm()
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 50257, (n,), generator=gen).numpy()
               for n in (5, 17, 40, 70, 9, 33)]
    runs = {}
    for eager in (False, True):
        eng = ServeEngine(cfg, model, slots=4, num_blocks=65, block_size=16,
                          prefill_chunk=32, temperature=temp, top_k=top_k)
        if eager:
            eng.fns.decode, eng.fns.prefill = (eng.fns.decode_fn,
                                               eng.fns.prefill_fn)
        DA.reset_launch_counts()
        runs[eager] = _engine_streams(eng, prompts, 12)
        steps = eng.steps["decode"] + eng.steps["prefill"]
        assert DA.LAUNCHES["paged_decode_attention"] == (steps
                                                         * cfg.num_layers)
        want = 0 if eager else 1
        assert eng.fns.captures == {"decode": want, "prefill": want}
    assert runs[False] == runs[True]


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [None, "int8"])
def test_captured_speculative_equals_vanilla_on_the_card(kv):
    """Speculative decoding (draft 2 of 4 layers, lookahead 3), captured,
    emits the captured vanilla stream bitwise, greedy and sampled, and
    equals its own eager run; K5 launches once a layer a step through the
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.models import generation

    cfg, model = _small_lm(kv_dtype=kv)
    prompt = torch.randint(0, 50257, (3, 21),
                           generator=torch.Generator().manual_seed(6))
    key = torch.tensor([0, 9]).numpy()
    for temp, top_k in ((0.0, None), (0.8, 10)):
        kw = dict(max_new_tokens=20, temperature=temp, top_k=top_k)
        van = generation.make_generate_fn(cfg, **kw)
        spec = generation.make_generate_fn(cfg, spec_draft_layers=2,
                                           spec_lookahead=3, **kw)
        want = van(model, prompt, key)
        DA.reset_launch_counts()
        got = spec(model, prompt, key)
        rounds = spec.last_stats["verify_steps"]
        assert DA.REGIME_LAUNCHES["decode_attention.split"] == rounds * (
            4 * 2 + 4)
        assert torch.equal(got, want)
        assert torch.equal(spec.eager(model, prompt, key), want)
        assert torch.equal(van.eager(model, prompt, key), want)
        assert spec.captures == van.captures == 1


@pytest.mark.gpu
def test_lora_engine_on_the_card():
    """The multi-LoRA engine, captured: adapter 0 is bitwise the base
    engine, adapter k the one-shot with ``adapter_id=k`` (prompts of 10 to
    32 tokens: one 32-row prefill chunk in the engine, one chunk of the
    prompt's length in the one-shot, both in K5/K6's chunk regime); a
    bank rewritten in place is served with no recapture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.models import generation
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
        init_adapter_bank,
    )

    cfg, model = _small_lm()
    lcfg = dataclasses.replace(cfg, lora_rank=4, lora_adapters=2)
    gen = torch.Generator(device="cuda").manual_seed(8)

    def bank():
        out = {}
        for name, z in init_adapter_bank(lcfg, device="cuda").items():
            t = torch.randn(z.shape, generator=gen, device="cuda") * 0.1
            t[0] = 0
            out[name] = t.to(z.dtype)
        return out

    # one prefill chunk each, in the chunk regime both ways (10+ rows)
    prompts = [torch.randint(0, 50257, (n,),
                             generator=torch.Generator().manual_seed(n))
               .numpy() for n in (10, 17, 30, 11, 32, 12)]
    ids = [i % 3 for i in range(6)]
    kw = dict(slots=4, num_blocks=65, block_size=16, prefill_chunk=32,
              temperature=0.8, top_k=10)
    base = _engine_streams(ServeEngine(cfg, model, **kw), prompts, 10)
    banks = [bank(), bank()]
    eng = ServeEngine(lcfg, model, adapters=banks[0], **kw)
    for n, b in enumerate(banks):
        if n:
            eng.load_adapter_bank(b)
        got = _engine_streams(eng, prompts, 10, adapters=ids, rid0=100 * n)
        assert eng.fns.captures == {"decode": 1, "prefill": 1}
        for i, a in enumerate(ids):
            if a == 0:
                assert got[i] == base[i]
                continue
            one = generation.make_generate_fn(
                lcfg, max_new_tokens=10, temperature=0.8, top_k=10,
                adapters=b, adapter_id=a)(
                    model, prompts[i][None], torch.tensor([0, 50 + i]).numpy())
            assert got[i] == one[0, len(prompts[i]):].tolist(), (n, i)
        assert any(got[i] != base[i] for i, a in enumerate(ids) if a)


# ---- the captured k-step train step and quantised products ----------------


def _train_lm(k, seed=0):
    """A small flash LM (bf16 compute, f32 weights), Adam with its counter
    on the card, and a k-step DataParallel step over stacked batches."""
    cfg = TF.TransformerConfig(vocab_size=512, num_layers=2, num_heads=2,
                               d_model=128, d_ff=256, max_len=256,
                               dtype=torch.bfloat16, attn_impl="flash")
    model = TF.Transformer(cfg).init_weights(seed).to("cuda")
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3,
                                               capturable=True))
    step = DataParallel().make_train_step(
        TF.make_lm_loss_fn(model), steps_per_call=k, stacked_batch=k > 1,
        per_step_metrics=k > 1)
    return cfg, state, step


def _packs(calls, k, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return [{"tokens": torch.randint(0, 512, (k, 2, 256), generator=gen)}
            for _ in range(calls)]


@pytest.mark.gpu
def test_captured_k_step_equals_its_eager_twin_on_the_card():
    """A 4-step DataParallel call captured as one CUDA graph against the
    same step run eagerly from the same weights: the per-step losses and
    the parameters after three calls bitwise equal, one capture, K1-K3
    counted k x layers a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, calls = 4, 3
    packs = _packs(calls, k)
    cfg, s_cap, cap = _train_lm(k)
    _, s_eag, eag = _train_lm(k)
    assert cap.captured is True
    losses = {"cap": [], "eag": []}
    for i, p in enumerate(packs):
        FA.reset_launch_counts()
        _, m = cap(s_cap, p)
        torch.cuda.synchronize()
        assert FA.LAUNCHES == {"flash_fwd": k * cfg.num_layers,
                               "flash_dq": k * cfg.num_layers,
                               "flash_dkv": k * cfg.num_layers,
                               "flash_carry": 0}, i
        losses["cap"].append(m["loss"])
        losses["eag"].append(eag.eager(s_eag, p)[1]["loss"])
    assert cap.captures == 1 and s_cap.step == s_eag.step == k * calls
    for a, b in zip(losses["cap"], losses["eag"]):
        assert a.shape == (k,) and torch.equal(a, b)
    assert len({x.item() for a in losses["cap"] for x in a}) == k * calls
    for a, b in zip(s_cap.model.parameters(), s_eag.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_the_first_captured_call_takes_k_optimizer_steps_not_2k():
    """The first call runs the k steps eagerly and captures them without
    running them: Adam's counter on the card reads k after it, 2k after
    the second call (the first replay)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k = 3
    _, state, step = _train_lm(k)
    packs = _packs(2, k, seed=4)
    step(state, packs[0])
    opt_step = next(iter(state.optimizer.state.values()))["step"]
    assert opt_step.is_cuda and opt_step.item() == k and state.step == k
    step(state, packs[1])
    assert opt_step.item() == 2 * k and state.step == 2 * k
    _, s1, one = _train_lm(1)
    for p in packs:
        for j in range(k):
            s1, _ = one.eager(s1, {"tokens": p["tokens"][j]})
    for a, b in zip(state.model.parameters(), s1.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_captured_step_refuses_an_adam_without_capturable():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, state, step = _train_lm(2)
    state.optimizer = torch.optim.Adam(state.model.parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="capturable=True"):
        step(state, _packs(1, 2)[0])


@pytest.mark.gpu
def test_fp8_casts_saturate_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.ops import quant

    x = torch.tensor([1e4, 500.0, 448.0, -1e9, 3.0, -0.0], device="cuda")
    assert quant.to_fp8(x).float().tolist() == [448.0, 448.0, 448.0,
                                                -448.0, 3.0, -0.0]
    w = torch.randn(64, 32, device="cuda")
    w[3, 4] = 1e6
    q, _ = quant.quantize_channelwise(w, bits="fp8")
    assert torch.isfinite(q.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 16, 8), (17, 13, 5), (1, 768, 2304),
                                   (8192, 768, 24), (100, 3072, 768)])
def test_int8_and_fp8_products_pad_odd_shapes_on_the_card(m, k, n):
    """``torch._int_mm`` takes m > 16 and k, n multiples of 8,
    ``torch._scaled_mm`` multiples of 16: other shapes are zero-padded,
    never run as a float product. The int8 sums are exact (int32, the
    CPU's bits). The card sums e4m3 products in its tensor cores at less
    than f32 precision (the measured gap to exact sums reaches ~1.6e-4 of
    the largest output), so the fp8 sums are held to 1e-3 of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    got = quant.int8_mm(a.cuda(), b.cuda())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), quant.int8_mm(a, b))
    fa = quant.to_fp8(torch.randn(m, k, generator=gen) * 50)
    fb = quant.to_fp8(torch.randn(k, n, generator=gen) * 50)
    got = quant.fp8_mm(fa.cuda(), fb.cuda())
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = fa.double() @ fb.double()
    gap = (got.cpu().double() - want).abs().max().item()
    assert gap <= 1e-3 * want.abs().max().item(), gap


@pytest.mark.gpu
@pytest.mark.parametrize("wd", ["int8", "int4", "fp8"])
def test_quantised_engine_equals_its_one_shot_on_the_card(wd):
    """A weight-only quantised model through the captured engine and the
    captured one-shot generator: the same greedy streams, bitwise (a
    prompt chunk of 10 to 32 rows on both sides: one K5/K6 regime)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.models.generation import (
        make_generate_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
    )

    cfg, model = _small_lm()
    qmodel = model.quantize(wd)
    qcfg = qmodel.cfg
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, 50257, (n,), generator=gen).numpy()
               for n in (12, 20, 31)]
    eng = ServeEngine(qcfg, qmodel, slots=4, num_blocks=65, block_size=16,
                      prefill_chunk=32)
    got = _engine_streams(eng, prompts, 10)
    assert eng.fns.captures == {"decode": 1, "prefill": 1}
    for i, p in enumerate(prompts):
        one = make_generate_fn(qcfg, max_new_tokens=10, temperature=0.0)
        out = one(qmodel, p[None], torch.tensor([0, 50 + i]).numpy())
        assert out[0, len(p):].tolist() == got[i], i


# ---- mixture of experts -----------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("top_k,capacity", [(1, 1024), (1, 300), (2, 600)])
def test_index_dispatch_is_bitwise_the_one_hot_plain_version_on_the_card(
        top_k, capacity):
    """``parallel/expert.route`` / ``dispatch`` / ``combine`` against the
    one-hot algebra (``route_onehot`` and its two einsums) on CUDA
    tensors at phase 28's shape (4096 bf16 tokens, d 768, 8 experts):
    the same expert buffer and the same combined output, bit for bit
    (exact row copies; one product a token at top-1, two summed in f32 at
    top-2), with and without drops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.parallel import expert as EP

    gen = torch.Generator(device="cuda").manual_seed(3)
    t, d, e = 4096, 768, 8
    x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    gates = torch.softmax(torch.randn(t, e, generator=gen, device="cuda")
                          * 2, dim=-1)
    r = EP.route(gates, top_k, capacity)
    buf = EP.dispatch(x, r)
    disp, comb = EP.route_onehot(gates, top_k, capacity)
    want = torch.einsum("tec,td->ecd", disp.bfloat16(), x)
    assert torch.equal(buf.view(e, capacity, d), want)
    out = torch.randn(e, capacity, d, generator=gen,
                      device="cuda").bfloat16()
    got = EP.combine(out.reshape(-1, d), r, torch.bfloat16)
    plain = torch.einsum("tec,ecd->td", comb.bfloat16(), out)
    if top_k == 1:
        assert torch.equal(got, plain)
    else:  # two f32 products summed, rounded once on both sides
        assert torch.allclose(got.float(), plain.float(), rtol=1e-2,
                              atol=1e-2)
    assert int(r.load.sum() + r.overflow.sum()) == top_k * t
    # ~512 choices an expert a round: 300 seats drop, 1024 do not
    assert bool(r.overflow.sum() > 0) == (capacity < 1000)


@pytest.mark.gpu
def test_router_gives_one_row_the_same_bits_in_an_8_row_batch():
    """``models/transformer.router_logits`` at GPT-2 widths and 8
    experts: a token's f32 logits are the same bits routed alone as
    inside an 8-row batch (an engine decode step against the solo
    generator)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(8, 768, generator=gen, device="cuda").bfloat16()
    w = torch.randn(8, 768, generator=gen, device="cuda") * 0.02
    batch = TF.router_logits(x, w)
    for i in range(8):
        assert torch.equal(TF.router_logits(x[i:i + 1], w)[0], batch[i]), i


@pytest.mark.gpu
def test_moe_engine_equals_its_solo_one_shot_on_the_card():
    """An MoE model (8 experts, capacity 1 at decode, so slots stall)
    through the captured engine: every greedy stream bitwise the solo
    one-shot generator's, the census balanced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.models.generation import (
        make_generate_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
    )

    cfg, model = _small_lm(moe_experts=8, moe_capacity=1)
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, 50257, (n,), generator=gen).numpy()
               for n in (12, 20, 31, 17)]
    eng = ServeEngine(cfg, model, slots=4, num_blocks=65, block_size=16,
                      prefill_chunk=32)
    got = _engine_streams(eng, prompts, 10)
    assert eng.fns.captures == {"decode": 1, "prefill": 1}
    moe = eng.health()["moe"]
    routed = sum(len(p) for p in prompts) + 4 * 9 + moe["stall_slot_ticks"]
    assert (sum(moe["expert_load"]) + sum(moe["expert_overflow"])
            == cfg.num_layers * routed)
    one = make_generate_fn(cfg, max_new_tokens=10, temperature=0.0)
    for i, p in enumerate(prompts):
        out = one(model, p[None], torch.tensor([0, 50 + i]).numpy())
        assert out[0, len(p):].tolist() == got[i], i


# ---- checkpoints and engine snapshots on the card -----------------------------


def _card_tensors(state):
    return ([t for t in state.model.state_dict().values()]
            + [v for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v)])


@pytest.mark.gpu
def test_async_save_of_cuda_state_survives_an_in_place_step(tmp_path):
    """``save(async_=True)`` copies the CUDA state to pinned host memory
    before it returns: the in-place Adam step run right after changes
    nothing that was saved, and the restore (onto ``cuda:0``, in place)
    gives the state at save time bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    _, state, step = _train_lm(1)
    packs = _packs(3, 1)
    state, _ = step(state, {"tokens": packs[0]["tokens"][0]})
    at_save = [t.clone() for t in _card_tensors(state)]
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, state, async_=True)
    state, _ = step(state, {"tokens": packs[1]["tokens"][0]})
    torch.cuda.synchronize()
    assert not all(torch.equal(a, b)
                   for a, b in zip(at_save, _card_tensors(state)))
    ckpt.wait()
    ptrs = [t.data_ptr() for t in _card_tensors(state)]
    ckpt.restore(state)
    assert [t.data_ptr() for t in _card_tensors(state)] == ptrs
    for a, b in zip(at_save, _card_tensors(state)):
        assert b.is_cuda and torch.equal(a, b)
    ckpt.close()


@pytest.mark.gpu
def test_restore_into_a_captured_multistep_continues_bitwise(tmp_path):
    """A k-step call captured as a CUDA graph: save after the first call,
    run on, restore in place and replay the graph (no recapture) over the
    rest of the stream: bitwise the uninterrupted captured run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (
        Checkpointer,
    )

    k = 2
    packs = _packs(4, k, seed=6)
    _, ref, ref_step = _train_lm(k)
    for p in packs:
        ref, _ = ref_step(ref, p)
    _, run, step = _train_lm(k)
    run, _ = step(run, packs[0])
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(run.step, run)
    run, _ = step(run, packs[1])
    run, _ = step(run, packs[2])
    restored, at = ckpt.restore_latest_valid(run)
    assert at == k and restored is run
    for p in packs[1:]:
        run, _ = step(run, p)
    assert step.captures == 1 and run.step == ref.step
    for a, b in zip(_card_tensors(ref), _card_tensors(run)):
        assert torch.equal(a, b)
    ckpt.close()


@pytest.mark.gpu
def test_engine_snapshot_restore_is_bitwise_on_the_card(tmp_path):
    """The captured engine killed after a snapshot and a fresh one
    restored from it: the residents re-prefill through the captured
    chunk and decode graphs and every stream is the uninterrupted
    engine's, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        Request,
        ServeEngine,
    )

    cfg, model = _small_lm()
    gen = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, 50257, (n,), generator=gen).numpy()
               for n in (5, 17, 40, 70, 9, 33)]
    kw = dict(slots=4, num_blocks=65, block_size=16, prefill_chunk=32,
              temperature=0.8, top_k=10)
    want = _engine_streams(ServeEngine(cfg, model, **kw), prompts, 12)

    def fresh():
        eng = ServeEngine(cfg, model, snapshot_dir=str(tmp_path / "s"),
                          **kw)
        return eng

    eng = fresh()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=12,
                           rng=torch.tensor([0, 50 + i]).numpy()))
    for _ in range(9):
        eng.step()
    label = eng.save_snapshot(async_=True)
    for _ in range(4):
        eng.step()
    eng.close()
    eng2 = fresh()
    assert eng2.restore_latest_snapshot() == label
    eng2.run()
    eng2.sched.pool.check_leaks()
    assert eng2.completions() == want
    assert eng2.fns.captures == {"decode": 1, "prefill": 1}
    eng2.close()


@pytest.mark.gpu
def test_fused_d2h_h2d_round_trip_of_an_int8_pool_in_place():
    """The engine's KVMover on an int8 pool: one gather of 8 blocks (K/V
    rows and their f32 scale rows) and one scatter of them into 8 other
    blocks give those blocks bitwise, leave every other block alone, and
    keep every pool leaf's storage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
        pool_leaves,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
        kv_block_bytes,
    )

    cfg, model = _small_lm(kv_dtype="int8")
    eng = ServeEngine(cfg, model, slots=4, num_blocks=65, block_size=16,
                      prefill_chunk=32, host_blocks=16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    leaves = pool_leaves(eng.pool)
    for leaf in leaves:
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device="cuda", dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen, device="cuda"))
    before = [t.clone() for t in leaves]
    ptrs = [t.data_ptr() for t in leaves]
    src, dst = list(range(1, 9)), list(range(40, 48))
    payloads = eng.kv.d2h(src)
    assert sum(a.nbytes for a in payloads[0]) == kv_block_bytes(cfg, 16)
    eng.kv.h2d(dst, payloads)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in leaves] == ptrs
    for t, old in zip(leaves, before):
        assert torch.equal(t[dst], old[src])
        keep = [b for b in range(t.shape[0]) if b not in dst]
        assert torch.equal(t[keep], old[keep])
    eng.close()


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [None, "int8"])
def test_swap_in_under_a_captured_decode_graph_is_bitwise(kv):
    """A pool too small for its residents, with a host tier: preempted
    streams spill and swap back in while the decode and prefill graphs
    replay over the same pool (one capture each, no leaf moved), and
    every stream equals a roomy pool's bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
        pool_leaves,
    )

    cfg, model = _small_lm(kv_dtype=kv)
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(0, 50257, (n,), generator=gen).numpy()
               for n in (40, 70, 33, 60)]
    kw = dict(slots=4, block_size=16, prefill_chunk=32, temperature=0.8,
              top_k=10)
    want = _engine_streams(ServeEngine(cfg, model, num_blocks=65, **kw),
                           prompts, 120)
    eng = ServeEngine(cfg, model, num_blocks=21, host_blocks=64, **kw)
    ptrs = [t.data_ptr() for t in pool_leaves(eng.pool)]
    got = _engine_streams(eng, prompts, 120)
    assert eng.sched.spill_resumes >= 1
    assert eng.fns.captures == {"decode": 1, "prefill": 1}
    assert [t.data_ptr() for t in pool_leaves(eng.pool)] == ptrs
    assert got == want
    eng.sched.check_leaks()
    eng.close()


@pytest.mark.gpu
def test_two_replica_fleet_migration_is_bitwise_on_the_card():
    """A disaggregated 2-replica fleet on one card: every stream prefills
    on one replica, moves with its KV to the other, and equals the
    uninterrupted single engine's stream bitwise; then a hard crash
    mid-run rebuilds its streams by ``"replay"``, still bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.fleet import (
        FleetScheduler,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
        kv_block_bytes,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.scheduler import (
        Request,
    )
    from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
        Fault,
        FaultSchedule,
    )

    cfg, model = _small_lm()
    gen = torch.Generator().manual_seed(17)
    prompts = [torch.randint(0, 50257, (n,), generator=gen).numpy()
               for n in (5, 17, 40, 70, 9, 33)]
    kw = dict(slots=4, num_blocks=65, block_size=16, prefill_chunk=32,
              temperature=0.8, top_k=10)
    want = _engine_streams(ServeEngine(cfg, model, **kw), prompts, 12)
    for fleet_kw in (dict(roles="disagg"),
                     dict(fleet_chaos=FaultSchedule(
                         [Fault("replica_crash", 4, 0.0)]))):
        fl = FleetScheduler(cfg, model, replicas=["cuda:0", "cuda:0"],
                            **kw, **fleet_kw)
        assert fl.continuations == "replay"
        for i, p in enumerate(prompts):
            fl.submit(Request(rid=i, prompt=p, max_new_tokens=12,
                              rng=torch.tensor([0, 50 + i]).numpy()))
        fl.run()
        assert fl.completions() == want
        if "roles" in fleet_kw:
            assert fl.migrations == len(prompts)
            assert fl.migration_bytes % kv_block_bytes(cfg, 16) == 0
        else:
            assert fl.replica_crashes == 1
        fl.check_leaks()
        fl.close()


@pytest.mark.gpu
def test_record_fed_steps_through_the_prefetch_are_bitwise(tmp_path):
    """A small GPT (flash, bf16) fed from token records by the native
    loader through ``DevicePrefetchIterator`` on ``cuda:0`` (pinned copies
    on a side stream, depth 2; int32 widened on the card) gives the same
    losses and parameters, bitwise, as the same steps fed from
    ``PyRecordLoader`` with synchronous copies: the side stream's event
    ordering hands every step its own batch, complete."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
        NativeRecordLoader,
        PyRecordLoader,
        make_fields,
        write_records,
    )
    from distributed_tensorflow_guide_tpu_torch.data.prefetch import (
        DevicePrefetchIterator,
    )
    from distributed_tensorflow_guide_tpu_torch.train.hooks import BaseHook

    S, B, steps = 256, 4, 6
    cfg = TF.TransformerConfig(vocab_size=512, num_layers=2, num_heads=4,
                               d_model=256, d_ff=1024, max_len=S,
                               causal=True, dtype=torch.bfloat16,
                               attn_impl="flash")
    fields = make_fields({"tokens": (np.int32, (S,))})
    path = tmp_path / "tokens.records"
    write_records(path, {"tokens": np.random.RandomState(0).randint(
        0, 512, (64, S)).astype(np.int32)}, fields)

    def run(feed):
        model = TF.Transformer(cfg).init_weights(0).to("cuda")
        state = TrainState(model, torch.optim.Adam(model.parameters(),
                                                   lr=1e-3))
        step = DataParallel(device="cuda").make_train_step(
            TF.make_lm_loss_fn(model))
        losses = []

        class Keep(BaseHook):
            def after_step(self, s, metrics):
                losses.append(metrics["loss"])

        TrainLoop(step, state, feed, hooks=[StopAtStepHook(steps), Keep()],
                  device="cuda").run()
        torch.cuda.synchronize()
        return [x.item() for x in losses], model.state_dict()

    native = NativeRecordLoader(path, fields, B, seed=3, prefetch=2)
    prefetch = DevicePrefetchIterator(native, device="cuda:0", depth=2)
    got, got_sd = run({"tokens": b["tokens"].long()} for b in prefetch)
    native.close()
    twin = PyRecordLoader(path, fields, B, seed=3)
    want, want_sd = run({"tokens": b["tokens"].astype(np.int64)}
                        for b in twin)
    assert prefetch.stats.batches >= steps
    assert prefetch.stats.peak_ahead == 2
    assert got == want
    assert all(torch.equal(got_sd[n], want_sd[n]) for n in want_sd)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_census_of_k5_and_k6_on_the_card_is_one_priced_node_each(kind):
    """The program auditor's census of one K5 and one K6 call on the card:
    one kernel node each (the launch itself is invisible to the dispatch
    mode), the call launched its kernel once, and the node prices at
    ``decode_kernel_hbm_bytes`` exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.analysis import cost, walker

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, s, hd, bs, c = 4, 12, 256, 64, 16, 1
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    k, v, ks, vs = _cache(kind, b, h, s, hd, gen, dev)
    n_blk = s // bs
    perm = torch.randperm(b * n_blk, generator=gen, device=dev)
    tables = perm.view(b, n_blk).to(torch.int32)
    kp, vp = _pool(k, perm, n_blk, 2), _pool(v, perm, n_blk, 2)
    ksp = None if ks is None else _pool(ks, perm, n_blk, 3)
    vsp = None if vs is None else _pool(vs, perm, n_blk, 3)
    q = torch.randn(b, c, h, hd, generator=gen, device=dev).to(q_dtype)
    index = torch.tensor([s - 1], dtype=torch.int32, device=dev)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    want = DA.decode_kernel_hbm_bytes(b=b, h=h, s=s, d=hd, dtype=k.dtype,
                                      chunk=c, q_dtype=q_dtype)
    calls = {
        "decode_attention": lambda: DA.decode_attention(
            q, k, v, index, key_scale=ks, value_scale=vs),
        "paged_decode_attention": lambda: DA.paged_decode_attention(
            q, kp, vp, tables, lens, key_scale_pool=ksp,
            value_scale_pool=vsp, block_size=bs),
    }
    for name, call in calls.items():
        before = DA.LAUNCHES[name]
        _, census = walker.record(call, (), device=dev)
        assert DA.LAUNCHES[name] == before + 1
        [node] = census.nodes
        assert (node.kind, node.name, node.regime) == ("kernel", name,
                                                        "split")
        vec = cost.census_cost(census)
        assert vec.hbm_bytes == want
        assert vec.flops == 4.0 * b * h * s * c * hd


@pytest.mark.gpu
def test_mesh_audit_on_two_ranks_sharing_the_card():
    """The auditor's world on the card: 2 gloo ranks time-sharing
    ``cuda:0`` lint ``dp_train_step`` and ``serve_kv_block_transfer_dcn``.
    Both pass every rule on both ranks with no bypass; the DP step's
    gradient ring and the transfer's one hop price at their closed forms
    as world means (the sending slice records P, the receiving one 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.analysis import cost, lint

    report = lint.run_contracts(
        lint._registered(("dp_train_step", "serve_kv_block_transfer_dcn")),
        "cuda:0", world=2)
    assert report.ok, lint.render_text(report)
    dp, kv = report.programs
    for p in (dp, kv):
        assert len(p.ranks) == 2
        for rank in p.ranks:
            coll = next(r for r in rank.rules if r.rule == "collectives")
            assert coll.observed["bypassing_ops"] == 0

    def mean(p, key):
        return next(r for r in p.rules if r.rule == "cost").observed[
            "collective_bytes_world_mean"][key]

    ar = cost.dp_allreduce_bytes
    assert mean(dp, "psum[data]") == ar(4288, 2) + 2 * ar(4, 2)
    P = 4 * 2 * 2 * 2 * 8 * 8 * 4
    assert [next(r for r in rank.rules if r.rule == "cost").observed[
        "collective_bytes"].get("ppermute[dcn]", 0.0)
        for rank in kv.ranks] == [P, 0.0]
    assert mean(kv, "ppermute[dcn]") == P / 2


# ---- CUDA prompts and rngs; the graft entry ---------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "top_k"])
def test_cuda_prompts_and_rngs_give_the_numpy_bits(temp, top_k):
    """GPT-2 widths at 2 layers: the one-shot generator (captured and
    eager) and the engine, given the prompt and the rng as CUDA tensors,
    emit their numpy-fed runs' tokens bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.models.generation import (
        make_generate_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        Request,
        ServeEngine,
    )

    cfg = dataclasses.replace(TF.gpt2_124m(dtype=torch.bfloat16),
                              num_layers=2, max_len=256)
    model = TF.Transformer(cfg).init_weights(0).to("cuda")
    g = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, 50257, (n,), generator=g).numpy()
               for n in (12, 20, 31)]
    keys = [np.array([0, 50 + i], np.uint32) for i in range(len(prompts))]
    gen = make_generate_fn(cfg, max_new_tokens=8, temperature=temp,
                           top_k=top_k)
    for i, (p, k) in enumerate(zip(prompts, keys)):
        cp = torch.as_tensor(p, device="cuda")[None]
        ck = torch.as_tensor(k.astype(np.int64), device="cuda")
        for run in (gen, gen.eager):
            want = run(model, p[None], k)
            got = run(model, cp, ck)
            assert got.device.type == "cuda" and torch.equal(got, want), i

    def serve(as_cuda):
        eng = ServeEngine(cfg, model, slots=4, num_blocks=65, block_size=16,
                          prefill_chunk=32, temperature=temp, top_k=top_k)
        for i, (p, k) in enumerate(zip(prompts, keys)):
            eng.submit(Request(
                rid=i, max_new_tokens=8,
                prompt=torch.as_tensor(p, device="cuda") if as_cuda else p,
                rng=(torch.as_tensor(k.astype(np.int64), device="cuda")
                     if as_cuda else k)))
        eng.run()
        eng.sched.pool.check_leaks()
        return eng.completions()

    assert serve(True) == serve(False)


@pytest.mark.gpu
def test_graft_entry_forward_runs_k1_once_a_layer():
    """``graft_entry.entry()`` on the card: its forward at (4, 1024) takes
    K1 once a layer (12) and no fallback, and its logits agree with the
    same model's dense attention (bf16 scores) within 2**-3: the logits
    reach |x| ~ 3, where a bf16 step is 2**-6, and the two attentions
    round their scores and probabilities at different places in each of
    12 layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch import graft_entry

    forward, (model, tokens) = graft_entry.entry()
    assert tokens.shape == (4, 1024) and tokens.device.type == "cuda"
    before = FA.fallback_stats()
    FA.reset_launch_counts()
    with torch.inference_mode():
        got = forward(model, tokens)
        torch.cuda.synchronize()
        assert FA.LAUNCHES == {"flash_fwd": 12, "flash_dq": 0,
                               "flash_dkv": 0, "flash_carry": 0}
        dense = model.with_config(dataclasses.replace(model.cfg,
                                                      attn_impl="dense"))
        want = forward(dense, tokens)
    assert FA.fallback_stats() == before
    assert got.shape == (4, 1024, 50304) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=2.0 ** -3, rtol=0)


@pytest.mark.gpu
def test_dryrun_multichip_on_two_ranks_sharing_the_card():
    """``dryrun_multichip(2)`` in one world of 2 gloo ranks on ``cuda:0``:
    every mode's line and the last line, with K1-K3 (mode 13's flash
    step), K4 (mode 8's ring) and K5's split regime (mode 16's
    generation) launched on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_tensorflow_guide_tpu_torch.runtime import (
        multiprocess as mp,
    )

    results = mp.run_multiprocess("tests.torch_mp_workers:graft_card_rank",
                                  2, [], timeout=600)
    lines = [ln for ln in results[0].stdout.splitlines()
             if not ln.startswith("DTG_MP_RESULT ")]
    assert len(lines) == 15, lines  # 14 mode lines (no 3D at 2), the last
    assert lines[-1] == ("dryrun_multichip(2): all sharding modes "
                         "compiled and ran")
    for r in results:
        launches = r.result
        for k in ("flash_fwd", "flash_dq", "flash_dkv", "flash_carry",
                  "decode_attention.split"):
            assert launches.get(k, 0) > 0, (r.rank, k, launches)
