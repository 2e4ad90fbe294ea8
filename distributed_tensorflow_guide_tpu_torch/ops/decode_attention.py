"""Decode attention: a chunk of C queries against a KV cache.

Two kernels, both written by hand for Hopper in ``csrc/decode_attention.cu``
(built by ``ops/_build.py``):

* **K5** :func:`decode_attention` reads a contiguous kernel-layout cache
  ``(B, H, S, hd)``; every request of the batch sits at the same
  position, which the kernel reads from device memory (a (1,) int32
  tensor): the one-shot generator (``models/generation.py``) replays one
  captured CUDA graph at every position.
* **K6** :func:`paged_decode_attention` reads a block pool
  ``(N, H, block_size, hd)`` through per-request block tables, each
  request at its own length (the serve engine's decode steps and prefill
  chunks, ``serve/engine.py``).

Both read only the live slice of the cache (the chunk's last position
bounds the KV loop), keep the online softmax on chip, and read an int8
cache natively: the per-row f32 scales fold into the score columns (k)
and into the probability columns (v, after the normaliser has been
summed), never into a dequantised copy.

Two regimes, picked on the host from C (:func:`decode_regime`):

* ``"split"`` — decode steps and short chunks, and every f32 call: the
  key axis is cut into splits of a fixed number of keys (absolute
  positions), one CTA per split, and a second kernel merges the splits'
  (m, l, acc) in split order. The plan is made here alone and handed to
  the kernels (split count and keys a split): the count comes from the
  cache's capacity only (:func:`split_count`: K5's S, K6's table width
  times the block size), never from a live length, so the wrapper reads
  no device value, one captured graph serves every position, and a
  request's output does not depend on its batch-mates. Splits past the
  live length exit early. The kernels' entry point refuses a plan that
  does not cover the capacity. :func:`split_attention_plain` is the same
  algorithm in PyTorch.

  The keys a split come from the caller (``split_keys=``; the engine and
  the one-shot resolve theirs once, :func:`resolve_split_keys`) or else
  from the tuning table's ``decode_split`` entry (``ops/autotune.py``),
  which K5 and K6 share: keyed on the heads, the head dim and the cache
  dtype, never on the batch, the capacity or the pool, so both kernels
  and every shape of a model split alike. Without an entry, and always
  on the CPU, it is :func:`split_keys`: ``SPLIT_KEYS``, or half that for
  f32 rows wider than 64. Valid counts are those the kernels take
  (:func:`split_keys_fit`).
* ``"chunk"`` — prefill chunks of at least ``CHUNK_MIN_ROWS`` rows with
  bf16 queries, a bf16 or int8 cache and a head dim that is a multiple of
  8: 64-row query tiles against 64-key tiles on the tensor cores
  (``wgmma``).

Dispatch rule: a wrapper runs its plain PyTorch version only when the
tensors lie on the CPU (the parity tests). A CUDA tensor launches the
kernels or raises; nothing falls back. Each wrapper call adds one to
``LAUNCHES[name]``, however many kernels it launches, and one to
``REGIME_LAUNCHES[name + "." + regime]``, so a run can show that its main
path went through the kernels, and through which regime how often. The
counts are kept in Python, so a call inside a CUDA graph counts when it
is captured; ``core/graphs.CapturedStep`` adds a graph's recorded
launches again at every replay and takes back what its warm-up and
capture counted.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_tensorflow_guide_tpu_torch.analysis import cost as _cost
from distributed_tensorflow_guide_tpu_torch.analysis import walker as _census
from distributed_tensorflow_guide_tpu_torch.ops import autotune
from distributed_tensorflow_guide_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    kernel_error,
)
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    gather_view,
)

NEG_INF = -1e30  # the finite mask value of the reference kernels
SPLIT_KEYS = 256  # default keys per split of the split regime
# the split kernel's limits (csrc/decode_attention.cu): 8 warps of up to
# 32 keys, at most 8 query rows a CTA, 227 KiB of shared memory a CTA
SPLIT_WARPS = 8
MAX_SPLIT_KEYS = SPLIT_WARPS * 32
SPLIT_ROWS = 8
SPLIT_SMEM_CAP = 227 * 1024
SWEEP_BLOCK_SIZE = 16  # the pool block size K6 is timed at without a pool
CHUNK_MIN_ROWS = 10  # chunks of at least this many rows take the tensor cores
KERNEL_SOURCE = ("distributed_tensorflow_guide_tpu_torch/ops/csrc/"
                 "decode_attention.cu")

LAUNCHES = {"decode_attention": 0, "paged_decode_attention": 0}
REGIME_LAUNCHES = {f"{name}.{regime}": 0 for name in LAUNCHES
                   for regime in ("split", "chunk")}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, REGIME_LAUNCHES):
        for k in counts:
            counts[k] = 0


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


def split_keys(kv_dtype: torch.dtype, head_dim: int) -> int:
    """Keys a split covers: ``SPLIT_KEYS``, or half of it where a split's
    K and V rows would not fit one CTA's shared memory (f32 rows wider
    than 64). Fixed per cache dtype and head dim."""
    wide = head_dim * kv_dtype.itemsize > 256
    return SPLIT_KEYS // 2 if wide else SPLIT_KEYS


def _split_pitch(hd: int, elem: int) -> int:
    """Bytes of one K or V row in a split CTA's shared memory: whole
    16-byte chunks, one more where their count is not a power of two (the
    unswizzled pitch)."""
    chunks = (hd * elem + 15) // 16
    return chunks * 16 + (0 if chunks & (chunks - 1) == 0 else 16)


def split_smem_bytes(keys: int, hd: int, elem: int, rows: int,
                     hdp: int | None = None) -> int:
    """Dynamic shared memory of a split CTA (``split_smem`` of the CUDA
    source): the split's K and V rows (reused for the warps' partial
    accumulators), q, and each warp's P and (m, l). ``hdp`` is the
    compiled head-dim tile, 64 or 128."""
    if hdp is None:
        hdp = 64 if hd <= 64 else 128
    kv = 2 * keys * _split_pitch(hd, elem)
    return (max(kv, SPLIT_WARPS * rows * hdp * 4) + rows * hdp * 4
            + SPLIT_WARPS * rows * (32 + 2) * 4)


def split_keys_fit(keys: int, hd: int, kv_dtype: torch.dtype) -> bool:
    """Whether the kernels take ``keys`` keys a split at this head dim
    and cache dtype: a multiple of the 8 warps, at most one key a lane
    (256), and a split CTA's shared memory within the cap the kernel opts
    in to, for one query row and for ``SPLIT_ROWS``."""
    keys = int(keys)
    if (keys < SPLIT_WARPS or keys % SPLIT_WARPS or keys > MAX_SPLIT_KEYS
            or not 1 <= hd <= MAX_HEAD_DIM):
        return False
    hdp = 64 if hd <= 64 else 128
    elem = kv_dtype.itemsize
    for rows in (1, SPLIT_ROWS):
        cap = min(split_smem_bytes(MAX_SPLIT_KEYS, hdp, elem, rows, hdp),
                  SPLIT_SMEM_CAP)
        if split_smem_bytes(keys, hd, elem, rows, hdp) > cap:
            return False
    return True


def split_count(span: int, keys: int = SPLIT_KEYS) -> int:
    """Splits of ``keys`` keys over ``span`` key positions (K5: the cache
    capacity S; K6: the table width times the block size): host-known
    sizes only, never a device length."""
    return max(1, -(-int(span) // keys))


def split_ranges(span: int, length: int,
                 keys: int = SPLIT_KEYS) -> list[tuple[int, int]]:
    """The key range [lo, hi) that each split reads for a request of live
    ``length``, in split order. A split that starts at or past the length
    reads nothing (lo == hi) and leaves an empty partial."""
    return [(lo, max(lo, min(lo + keys, int(length))))
            for lo in range(0, split_count(span, keys) * keys, keys)]


def decode_regime(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                  head_dim: int, chunk: int) -> str:
    """"chunk" (tensor cores) for a prefill chunk of at least
    ``CHUNK_MIN_ROWS`` rows with bf16 queries, a bf16 or int8 cache and a
    head dim that is a multiple of 8; "split" (split-KV on CUDA cores)
    for everything else, every f32 call included."""
    if (q_dtype == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.int8)
            and head_dim % 8 == 0 and chunk >= CHUNK_MIN_ROWS):
        return "chunk"
    return "split"


def split_attention_plain(q, k, v, ks, vs, q_pos, span: int,
                          keys: int = SPLIT_KEYS):
    """The split regime's algorithm in PyTorch, on :func:`_attend`'s
    operands: for each split of ``keys`` keys the partial
    (m, l, acc) of its keys (a split past the cache: m = NEG_INF, l = 0,
    acc = 0), then the partials merged in split order,
    O = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s. Equal to the one-pass
    :func:`_attend` within f32 rounding."""
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    B, C, H = q.shape[:3]
    qf = q.float()
    parts = []
    for lo, _ in split_ranges(span, span, keys):
        kk = k[:, :, lo:lo + keys].float()
        if kk.shape[2] == 0:
            parts.append((qf.new_full((B, H, C, 1), NEG_INF),
                          qf.new_zeros(B, H, C, 1),
                          qf.new_zeros(B, H, C, hd)))
            continue
        s = torch.einsum("bchd,bhkd->bhck", qf, kk) * scale
        if ks is not None:
            s = s * ks[..., lo:lo + keys]
        k_pos = lo + torch.arange(kk.shape[2], device=q.device)
        mask = k_pos[None, None, :] <= q_pos[:, :, None]
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
        l = p.sum(dim=-1, keepdim=True)
        if vs is not None:
            p = p * vs[..., lo:lo + keys]
        acc = torch.einsum("bhck,bhkd->bhcd", p,
                           v[:, :, lo:lo + keys].float())
        parts.append((m, l, acc))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_sum = torch.zeros_like(big_m)
    acc_sum = qf.new_zeros(B, H, C, hd)
    for m, l, acc in parts:  # split order
        w = torch.exp(m - big_m)
        l_sum = l_sum + w * l
        acc_sum = acc_sum + w * acc
    safe_l = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
    return (acc_sum / safe_l).permute(0, 2, 1, 3).to(q.dtype)


def device_index(index, device) -> torch.Tensor:
    """K5's write index as the kernel reads it: a (1,) int32 tensor on
    ``device``. A tensor (0-d or (1,), any integer dtype) stays on the
    device (a cast at most); a Python int is copied there."""
    if isinstance(index, torch.Tensor):
        return index.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([index], dtype=torch.int32, device=device)


def decode_attention_plain(q, cached_key, cached_value, index, *,
                           key_scale=None, value_scale=None):
    """K5's function in PyTorch. ``index`` (an int, or a 0-d or (1,)
    integer tensor that stays where it is) is the position of the chunk's
    first row; rows at or past ``index + C`` are zeroed before they meet
    the scores or the probabilities, so whatever the cache holds there
    (NaN included) cannot reach the output, and no device value is read
    on the host. The live length ``index + C`` is clamped to [1, S] and
    the chunk's rows sit at ``length - C + c``, as the kernel reads a
    device index: the same function as the kernel's for an index out of
    range too."""
    B, C = q.shape[:2]
    S = cached_key.shape[2]
    idx = device_index(index, q.device).to(torch.int64)
    length = torch.clamp(idx + C, min=1, max=S)  # (1,)
    k_pos = torch.arange(S, device=q.device)
    live = k_pos < length  # (S,)

    def kept(t, axis):
        shape = [1] * t.ndim
        shape[axis] = S
        return torch.where(live.view(shape), t, torch.zeros_like(t))

    k, v = kept(cached_key, 2), kept(cached_value, 2)
    ks = kept(key_scale, 3) if key_scale is not None else None
    vs = kept(value_scale, 3) if value_scale is not None else None
    q_pos = (length - C + torch.arange(C, device=q.device))[None, :]
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
            [vp] * 8 + [i] * 5 + [i, i, f, i, i, vp])
        lib.dtg_decode_attention.restype = ctypes.c_int
        lib.dtg_paged_decode_attention.argtypes = (
            [vp] * 9 + [i] * 6 + [i, i, f, i, i, vp])
        lib.dtg_paged_decode_attention.restype = ctypes.c_int
        lib._dtg_bound = True
    return lib


def _check_cuda(q, k, v, ks, vs, scale_shape):
    """The layouts the kernels take; anything else raises. ``scale_shape``
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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernels take 1 to "
                         f"{MAX_HEAD_DIM}")
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


def _plan(q, regime: str, kv_dtype, span: int, keys: int | None = None,
          block_size: int | None = None):
    """(n_splits, keys, workspace) of a launch: 0, 0 and no workspace for
    the chunk regime; else the split count over ``span`` keys, the keys
    of a split (the caller's, else the table's ``decode_split`` entry:
    the kernel takes both from here) and, for more than one split, the
    f32 workspace of the splits' partials (acc, then m and l)."""
    B, C, H, hd = q.shape
    if regime == "chunk":
        return 0, 0, None
    if keys is None:
        keys = autotune.split_keys_for(h=H, d=hd, dtype=kv_dtype,
                                       block_size=block_size,
                                       device=q.device)
    elif not split_keys_fit(keys, hd, kv_dtype):
        raise ValueError(f"split_keys {keys}: the kernels take "
                         f"{autotune.split_keys_candidates(hd, kv_dtype)}"
                         f" (or another multiple of {SPLIT_WARPS} that "
                         f"fits) at head dim {hd}, {kv_dtype} rows")
    n = split_count(span, keys)
    if n == 1:
        return n, keys, None
    return n, keys, torch.empty(B * H * C * n * (hd + 2),
                                dtype=torch.float32, device=q.device)


# --------------------------------------------------------------------------
# kernel nodes of the program auditor's census (analysis/walker.py)
# --------------------------------------------------------------------------


def _k5_node(q, cached_key, cached_value, index, *, key_scale=None,
             value_scale=None, split_keys=None):
    B, C, H, hd = q.shape
    attrs = dict(b=B, h=H, s=cached_key.shape[2], d=hd, chunk=C,
                 kv_dtype=cached_key.dtype, q_dtype=q.dtype)
    return (decode_regime(q.dtype, cached_key.dtype, hd, C),
            (q, cached_key, cached_value, index, key_scale, value_scale),
            attrs)


def _k6_node(q, key_pool, value_pool, block_tables, lengths, *,
             key_scale_pool=None, value_scale_pool=None, block_size: int,
             split_keys=None):
    B, C, H, hd = q.shape
    attrs = dict(b=B, h=H, s=block_tables.shape[1] * block_size, d=hd,
                 chunk=C, kv_dtype=key_pool.dtype, q_dtype=q.dtype)
    return (decode_regime(q.dtype, key_pool.dtype, hd, C),
            (q, key_pool, value_pool, block_tables, lengths,
             key_scale_pool, value_scale_pool), attrs)


def decode_node_cost(node) -> dict:
    """The cost of one K5 / K6 node: :func:`decode_kernel_hbm_bytes` at
    the node's shapes, exactly (the cache, K6's whole table span, read
    once; q read and the output written once), and 4·B·H·S·C·hd flops.
    The closed form leaves out the kernel's metadata: K5's (1,) int32
    index (4 bytes) and K6's block tables and lengths are not counted."""
    a = node.attrs
    total = decode_kernel_hbm_bytes(b=a["b"], h=a["h"], s=a["s"], d=a["d"],
                                    dtype=a["kv_dtype"], chunk=a["chunk"],
                                    q_dtype=a["q_dtype"])
    out = a["b"] * a["h"] * a["chunk"] * a["d"] * a["q_dtype"].itemsize
    return {"flops": 4.0 * a["b"] * a["h"] * a["s"] * a["chunk"] * a["d"],
            "read": total - out, "write": float(out)}


_cost.register_kernel_cost("decode_attention", decode_node_cost)
_cost.register_kernel_cost("paged_decode_attention", decode_node_cost)


@_census.kernel_entry("decode_attention", _k5_node)
def decode_attention(q, cached_key, cached_value, index, *,
                     key_scale=None, value_scale=None,
                     split_keys: int | None = None):
    """K5: attention of a (B, C, H, hd) chunk against a contiguous
    (B, H, S, hd) cache whose rows ``[index, index + C)`` already hold the
    chunk's k/v. ``index`` is a 0-d or (1,) int32 tensor on q's device,
    which the kernel reads there (a Python int is copied to the device
    first; on the card an int out of range raises); the live length
    ``index + C`` is clamped to [1, S], here and in the plain version
    alike, so the caller keeps it inside the cache. int8 caches come with
    (B, H, 1, S) f32 scales. ``split_keys``: the keys a split of the
    split regime (None: the tuning table's entry). Returns (B, C, H, hd)
    in q's dtype. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cached_key, cached_value, index,
                                      key_scale=key_scale,
                                      value_scale=value_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, C, H, hd = q.shape
    S = cached_key.shape[2]
    if cached_key.shape != (B, H, S, hd) or not 0 < C <= S:
        raise ValueError(f"cache {tuple(cached_key.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if isinstance(index, torch.Tensor):
        if (index.numel() != 1 or index.device != q.device
                or index.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"index must be one int32/int64 value on "
                             f"{q.device}, got {tuple(index.shape)} "
                             f"{index.dtype} on {index.device}")
    elif not 0 <= index <= S - C:  # a host int is checked on the host
        raise ValueError(f"index {index} + chunk {C} does not fit the "
                         f"cache's {S} rows")
    index = device_index(index, q.device)
    q = q.contiguous()
    _check_cuda(q, cached_key, cached_value, key_scale, value_scale,
                (B, H, 1, S))
    out = torch.empty_like(q)
    regime = decode_regime(q.dtype, cached_key.dtype, hd, C)
    n_splits, keys, ws = _plan(q, regime, cached_key.dtype, S,
                               split_keys)
    rc = _lib().dtg_decode_attention(
        _ptr(q), _ptr(cached_key), _ptr(cached_value), _ptr(key_scale),
        _ptr(value_scale), _ptr(out), _ptr(ws), _ptr(index), B, C, H, hd,
        S, _DTYPE_CODE[q.dtype], _DTYPE_CODE[cached_key.dtype],
        1.0 / hd ** 0.5, n_splits, keys,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"{kernel_error(rc)}")
    LAUNCHES["decode_attention"] += 1
    REGIME_LAUNCHES[f"decode_attention.{regime}"] += 1
    return out


@_census.kernel_entry("paged_decode_attention", _k6_node)
def paged_decode_attention(q, key_pool, value_pool, block_tables, lengths,
                           *, key_scale_pool=None, value_scale_pool=None,
                           block_size: int, split_keys: int | None = None):
    """K6: attention of a (B, C, H, hd) chunk against a block pool
    (N, H, block_size, hd) read through ``block_tables`` (B, n_blk)
    int32. ``lengths`` (B,) int32 count the chunk; each is clamped to at
    least 1. int8 pools come with (N, H, 1, block_size) f32 scale pools.
    ``split_keys`` as :func:`decode_attention`'s. Returns (B, C, H, hd)
    in q's dtype. CPU tensors take the plain version. On the card the
    lengths stay on the device: the split count comes from the table's
    width."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, key_pool, value_pool, block_tables, lengths,
            key_scale_pool=key_scale_pool,
            value_scale_pool=value_scale_pool, block_size=block_size)
    return paged_decode_attention_kernel(
        q, key_pool, value_pool, block_tables, lengths,
        key_scale_pool=key_scale_pool, value_scale_pool=value_scale_pool,
        block_size=block_size, split_keys=split_keys)


def paged_decode_attention_kernel(q, key_pool, value_pool, block_tables,
                                  lengths, *, key_scale_pool=None,
                                  value_scale_pool=None, block_size: int,
                                  regime: str | None = None,
                                  split_keys: int | None = None):
    """K6 on the card: :func:`paged_decode_attention`'s CUDA path, in the
    regime :func:`decode_regime` picks, or in ``regime`` where the caller
    names one (the measurement the threshold rests on); a regime the
    kernels do not take for these dtypes or head dim raises."""
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
    n_blk = block_tables.shape[1]
    regime = regime or decode_regime(q.dtype, key_pool.dtype, hd, C)
    n_splits, keys, ws = _plan(q, regime, key_pool.dtype,
                               n_blk * block_size, split_keys, block_size)
    rc = _lib().dtg_paged_decode_attention(
        _ptr(q), _ptr(key_pool), _ptr(value_pool), _ptr(key_scale_pool),
        _ptr(value_scale_pool), _ptr(block_tables), _ptr(lengths),
        _ptr(out), _ptr(ws), B, C, H, hd, block_size, n_blk,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[key_pool.dtype],
        1.0 / hd ** 0.5, n_splits, keys,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"{kernel_error(rc)}")
    LAUNCHES["paged_decode_attention"] += 1
    REGIME_LAUNCHES[f"paged_decode_attention.{regime}"] += 1
    return out


# --------------------------------------------------------------------------
# the keys a split: the sweep's runners and the resolution
# --------------------------------------------------------------------------


def make_split_runners(*, b: int, h: int, s: int, d: int,
                       dtype: torch.dtype, q_dtype=None, block_size: int,
                       n_blk: int | None = None, device, seed: int = 0):
    """What the ``decode_split`` sweep times, on seeded random operands:
    ``k5(keys)``, one K5 decode step (B=``b``, C=1) against a full
    (B, H, S, hd) cache at ``dtype`` (int8 with its scales), and
    ``k6(keys)``, one K6 decode step at the same B through shuffled block
    tables of ``n_blk`` blocks (default S / block_size) into a pool of
    B * n_blk blocks, every request at full length; ``k5_plain(keys)`` /
    ``k6_plain(keys)`` are :func:`split_attention_plain` on the same
    operands with the same keys. ``q_dtype`` defaults to f32 for an f32
    cache, else bf16."""
    from types import SimpleNamespace

    dev = torch.device(device)
    if q_dtype is None:
        q_dtype = torch.float32 if dtype == torch.float32 else torch.bfloat16
    n_blk = n_blk or -(-s // block_size)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def cache(shape):
        pair = []
        for _ in range(2):
            x = torch.randn(shape, generator=gen, device=dev)
            if dtype == torch.int8:
                x8, sc = quantize_kv(x)
                pair.append((x8, sc.unsqueeze(2).contiguous()))
            else:
                pair.append((x.to(dtype), None))
        (k, ks), (v, vs) = pair
        return k, v, ks, vs

    q = torch.randn(b, 1, h, d, generator=gen, device=dev).to(q_dtype)
    k, v, ks, vs = cache((b, h, s, d))
    index = torch.tensor([s - 1], dtype=torch.int32, device=dev)
    kp, vp, ksp, vsp = cache((b * n_blk, h, block_size, d))
    perm = torch.randperm(b * n_blk, generator=gen, device=dev)
    tables = perm.view(b, n_blk).to(torch.int32).contiguous()
    span = n_blk * block_size
    lengths = torch.full((b,), span, dtype=torch.int32, device=dev)

    def k5(keys):
        return decode_attention(q, k, v, index, key_scale=ks,
                                value_scale=vs, split_keys=keys)

    def k6(keys):
        return paged_decode_attention(q, kp, vp, tables, lengths,
                                      key_scale_pool=ksp,
                                      value_scale_pool=vsp,
                                      block_size=block_size,
                                      split_keys=keys)

    def k5_plain(keys):
        q_pos = torch.full((b, 1), s - 1, device=dev)
        return split_attention_plain(q, k, v, ks, vs, q_pos, s, keys)

    def k6_plain(keys):
        kg, vg = (gather_view(t, tables, seq_axis=2) for t in (kp, vp))
        ksg = vsg = None
        if ksp is not None:
            ksg, vsg = (gather_view(t, tables, seq_axis=3)
                        for t in (ksp, vsp))
        q_pos = (lengths.to(torch.int64) - 1)[:, None]
        return split_attention_plain(q, kg, vg, ksg, vsg, q_pos, span, keys)

    return SimpleNamespace(k5=k5, k6=k6, k5_plain=k5_plain,
                           k6_plain=k6_plain, device=dev)


def resolve_split_keys(*, h: int, hd: int, kv_dtype: torch.dtype,
                       q_dtype: torch.dtype, device, b: int, s: int,
                       block_size: int | None = None,
                       n_blk: int | None = None, iters: int = 20) -> int:
    """The keys a split that a model's decode views take, resolved once
    before any graph is captured: the table's ``decode_split`` entry
    through the online front door (``autotune.ensure_tuned_online``),
    which, with online tuning on and no entry, sweeps K5 at (``b``,
    ``s``) and K6 at ``b`` over ``n_blk`` blocks of ``block_size`` (the
    engine's pool; ``SWEEP_BLOCK_SIZE`` without one) and records the
    winner. With a ``block_size`` whose multiple the keys are not, the
    fixed rule (:func:`split_keys`). On the CPU: the fixed rule."""
    bs = block_size or SWEEP_BLOCK_SIZE
    keys = autotune.ensure_tuned_online(
        autotune.DECODE_SPLIT_KERNEL, h=h, d=hd, dtype=kv_dtype,
        device=device, iters=iters,
        shape={"b": b, "s": s, "block_size": bs, "n_blk": n_blk,
               "q_dtype": q_dtype})
    if block_size and keys % block_size:
        return split_keys(kv_dtype, hd)
    return keys
