"""The hand-written decode-attention kernels (K5, K6) against their plain
PyTorch versions, on CUDA tensors.

Needs the card; each test decides inside itself to skip where there is
none. This file imports neither jax nor the JAX package, so it also runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_gpu.py

Tolerances: float32 1e-5 (the kernel sums the same products in another
order); bf16 outputs 1e-2, one bf16 step at |x| < 2 (the kernel rounds an
f32 result once, the plain version after other f32 roundings).
"""

import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA

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
