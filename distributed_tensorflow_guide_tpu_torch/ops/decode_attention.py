"""Decode attention: a chunk of C queries against a KV cache.

Two kernels, both written by hand for Hopper in ``csrc/decode_attention.cu``
(one templated CUDA kernel, built by ``ops/_build.py``):

* **K5** :func:`decode_attention` reads a contiguous kernel-layout cache
  ``(B, H, S, hd)``; every request of the batch sits at the same
  position (the one-shot generator, ``models/generation.py``).
* **K6** :func:`paged_decode_attention` reads a block pool
  ``(N, H, block_size, hd)`` through per-request block tables, each
  request at its own length (the serve engine's decode steps and prefill
  chunks, ``serve/engine.py``).

Both read only the live slice of the cache (the chunk's last position
bounds the KV loop), keep the online softmax in registers, and read an
int8 cache natively: the per-row f32 scales fold into the score columns
(k) and into the probability columns (v, after the normaliser has been
summed), never into a dequantised copy.

Dispatch rule: a wrapper runs its plain PyTorch version only when the
tensors lie on the CPU (the parity tests). A CUDA tensor launches the
kernel or raises; nothing falls back. Each launch adds one to
``LAUNCHES[name]`` so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    gather_view,
)

NEG_INF = -1e30  # the finite mask value of the reference kernels
MAX_HEAD_DIM = 128
KERNEL_SOURCE = "distributed_tensorflow_guide_tpu_torch/ops/csrc/decode_attention.cu"

LAUNCHES = {"decode_attention": 0, "paged_decode_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# int8 KV quantization and the byte model
# --------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: ``x`` (..., hd) -> (values int8 (..., hd),
    scales f32 (...,)). An all-zero vector gets scale 1 (not 0), so
    dequantisation is always exact zero, never 0/0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    values = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return values.to(torch.int8), scale


def cache_slot_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Bytes one (slot, head) of the cache occupies: K and V vectors at
    the cache dtype, plus two f32 scales when the cache is int8."""
    scales = 8 if dtype == torch.int8 else 0
    return 2 * head_dim * dtype.itemsize + scales


def decode_kernel_hbm_bytes(*, b: int, h: int, s: int, d: int,
                            dtype: torch.dtype, chunk: int = 1,
                            q_dtype: torch.dtype = torch.bfloat16,
                            effective_len: int | None = None) -> float:
    """Least HBM traffic of one kernel call: the q chunk read and the
    output written once, the live slice of the cache (K, V and, for int8,
    the scale rows) read once. ``effective_len`` is the live length; the
    default is the full cache."""
    length = s if effective_len is None else min(int(effective_len), s)
    cache = b * h * length * cache_slot_bytes(d, dtype)
    qo = 2 * b * h * chunk * d * q_dtype.itemsize
    return float(cache + qo)


# --------------------------------------------------------------------------
# plain versions (what the CPU runs, and what the kernels are held to)
# --------------------------------------------------------------------------


def _attend(q, k, v, ks, vs, q_pos):
    """Shared algebra. q (B, C, H, hd); k, v (B, H, L, hd) any dtype;
    ks, vs (B, H, 1, L) f32 or None; q_pos (B, C) absolute positions.
    Key p is visible to query row c when p <= q_pos[b, c]."""
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bchd,bhkd->bhck", q.float(), k.float()) * scale
    if ks is not None:
        s = s * ks  # k dequant folds into the score columns
    k_pos = torch.arange(k.shape[2], device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]  # (B, C, L)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs  # v dequant, after l has summed the raw p
    acc = torch.einsum("bhck,bhkd->bchd", p, v.float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)  # (B, H, C, 1)
    return (acc / safe_l.permute(0, 2, 1, 3)).to(q.dtype)


def decode_attention_plain(q, cached_key, cached_value, index, *,
                           key_scale=None, value_scale=None):
    """K5's function in PyTorch. ``index`` is the position of the chunk's
    first row; only cache rows below ``index + C`` are read."""
    B, C = q.shape[:2]
    length = int(index) + C
    k, v = cached_key[:, :, :length], cached_value[:, :, :length]
    ks = key_scale[..., :length] if key_scale is not None else None
    vs = value_scale[..., :length] if value_scale is not None else None
    q_pos = (int(index) + torch.arange(C, device=q.device))[None, :]
    return _attend(q, k, v, ks, vs, q_pos.expand(B, C))


def paged_decode_attention_plain(q, key_pool, value_pool, block_tables,
                                 lengths, *, key_scale_pool=None,
                                 value_scale_pool=None, block_size: int):
    """K6's function in PyTorch. ``lengths`` (B,) count the chunk: request
    b's rows sit at positions ``[lengths[b] - C, lengths[b])``."""
    B, C = q.shape[:2]
    lengths = torch.clamp(lengths.to(torch.int64), min=1)
    # only the table columns some request's length reaches are read
    live = block_tables[:, :-(-int(lengths.max()) // block_size)]
    k = gather_view(key_pool, live, seq_axis=2)
    v = gather_view(value_pool, live, seq_axis=2)
    ks = vs = None
    if key_scale_pool is not None:
        ks = gather_view(key_scale_pool, live, seq_axis=3)
        vs = gather_view(value_scale_pool, live, seq_axis=3)
    q_pos = (lengths[:, None] - C
             + torch.arange(C, device=q.device)[None, :])
    return _attend(q, k, v, ks, vs, q_pos)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _lib():
    from distributed_tensorflow_guide_tpu_torch.ops import _build

    lib = _build.load("decode_attention")
    if not getattr(lib, "_dtg_bound", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dtg_decode_attention.argtypes = (
            [vp] * 6 + [i] * 6 + [i, i, f, vp])
        lib.dtg_decode_attention.restype = ctypes.c_int
        lib.dtg_paged_decode_attention.argtypes = (
            [vp] * 8 + [i] * 6 + [i, i, f, vp])
        lib.dtg_paged_decode_attention.restype = ctypes.c_int
        lib._dtg_bound = True
    return lib


def _check_cuda(q, k, v, ks, vs, scale_shape):
    """The layouts the kernel takes; anything else raises. ``scale_shape``
    is the shape int8 scale tensors must have."""
    hd = q.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: kernel takes float32/bfloat16")
    quant = k.dtype == torch.int8
    if not quant and k.dtype != q.dtype:
        raise TypeError(f"cache dtype {k.dtype} must be int8 or q's "
                        f"{q.dtype}")
    if quant != (ks is not None) or (ks is None) != (vs is None):
        raise ValueError("an int8 cache needs both scale tensors, and only "
                         "an int8 cache takes them")
    if quant and not all(t.dtype == torch.float32
                         and tuple(t.shape) == scale_shape for t in (ks, vs)):
        raise ValueError(f"int8 scales must be float32 of shape "
                         f"{scale_shape}")
    per_vec = 16 // k.dtype.itemsize
    if hd > MAX_HEAD_DIM or hd % per_vec or hd % 4:
        raise ValueError(f"head_dim {hd}: kernel takes a multiple of "
                         f"{per_vec} up to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_scale", ks),
                    ("v_scale", vs)):
        if t is None:
            continue
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError("key and value caches differ in shape")


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_attention(q, cached_key, cached_value, index, *,
                     key_scale=None, value_scale=None):
    """K5: attention of a (B, C, H, hd) chunk against a contiguous
    (B, H, S, hd) cache whose rows ``[index, index + C)`` already hold the
    chunk's k/v. int8 caches come with (B, H, 1, S) f32 scales. Returns
    (B, C, H, hd) in q's dtype. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cached_key, cached_value, index,
                                      key_scale=key_scale,
                                      value_scale=value_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, C, H, hd = q.shape
    S = cached_key.shape[2]
    length = int(index) + C
    if cached_key.shape != (B, H, S, hd) or not 0 < length <= S:
        raise ValueError(f"cache {tuple(cached_key.shape)} / index {index} "
                         f"do not fit q {tuple(q.shape)}")
    q = q.contiguous()
    _check_cuda(q, cached_key, cached_value, key_scale, value_scale,
                (B, H, 1, S))
    out = torch.empty_like(q)
    rc = _lib().dtg_decode_attention(
        _ptr(q), _ptr(cached_key), _ptr(cached_value), _ptr(key_scale),
        _ptr(value_scale), _ptr(out), B, C, H, hd, S, length,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[cached_key.dtype],
        1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cuda error {rc}")
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(q, key_pool, value_pool, block_tables, lengths,
                           *, key_scale_pool=None, value_scale_pool=None,
                           block_size: int):
    """K6: attention of a (B, C, H, hd) chunk against a block pool
    (N, H, block_size, hd) read through ``block_tables`` (B, n_blk)
    int32. ``lengths`` (B,) int32 count the chunk; each is clamped to at
    least 1. int8 pools come with (N, H, 1, block_size) f32 scale pools.
    Returns (B, C, H, hd) in q's dtype. CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, key_pool, value_pool, block_tables, lengths,
            key_scale_pool=key_scale_pool,
            value_scale_pool=value_scale_pool, block_size=block_size)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    B, C, H, hd = q.shape
    N = key_pool.shape[0]
    if key_pool.shape != (N, H, block_size, hd):
        raise ValueError(f"pool {tuple(key_pool.shape)} does not fit q "
                         f"{tuple(q.shape)} / block_size {block_size}")
    for name, t in (("block_tables", block_tables), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on "
                             f"{q.device}")
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("block_tables / lengths do not match the batch")
    q = q.contiguous()
    _check_cuda(q, key_pool, value_pool, key_scale_pool, value_scale_pool,
                (N, H, 1, block_size))
    out = torch.empty_like(q)
    rc = _lib().dtg_paged_decode_attention(
        _ptr(q), _ptr(key_pool), _ptr(value_pool), _ptr(key_scale_pool),
        _ptr(value_scale_pool), _ptr(block_tables), _ptr(lengths),
        _ptr(out), B, C, H, hd, block_size, block_tables.shape[1],
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[key_pool.dtype],
        1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"cuda error {rc}")
    LAUNCHES["paged_decode_attention"] += 1
    return out
