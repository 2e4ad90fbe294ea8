"""Fused flash attention: forward, backward and the ring-attention carry
step as hand-written CUDA kernels.

Four kernels, written by hand for Hopper in ``csrc/flash_attention.cu``
(built by ``ops/_build.py``):

* **K1** :func:`flash_fwd` — online-softmax forward; gives O and the
  per-row log-sum-exp (LSE) the backward recomputes P from;
* **K2** :func:`flash_bwd_dq` — dQ, one CTA per query tile;
* **K3** :func:`flash_bwd_dkv` — dK and dV, one CTA per key tile;
* **K4** :func:`flash_carry_step` — one ring-attention visit: K1's loop
  over a visiting KV shard, merged into an un-normalised carry (m, l, acc)
  that enters and leaves in device memory (``parallel/sequence.py``);
  :func:`carry_init` and :func:`carry_finalize` open and close a ring.

:func:`flash_attention` (the public call, layout (B, S, H, D)) is a
``torch.autograd.Function`` over them: the forward saves q, k, v, out and
a compact f32 LSE of shape (B, H, S); the backward forms
``delta = rowsum(dO * O)`` in f32 and runs K2 and K3. No (S, S) matrix is
ever stored.

Head dims: the kernels take multiples of 8 up to ``MAX_HEAD_DIM``; the
wrappers zero-pad any other head dim up to the next multiple of 8 (zero
columns change no score and no output column; the scale stays the
caller's) and slice the outputs back.

Dispatch rule: a wrapper runs its plain PyTorch version
(:func:`flash_fwd_plain`, :func:`flash_bwd_dq_plain`,
:func:`flash_bwd_dkv_plain`, :func:`flash_carry_step_plain`) only when the
tensors lie on the CPU. A CUDA
tensor launches the kernel or raises; nothing falls back. Each launch adds
one to ``LAUNCHES[name]``.

Fallback rule, CPU tensors only: ``blk_q``/``blk_k`` keep the JAX
package's meaning there. They decide which sequence lengths take the
fused path (:func:`supported`: S a multiple of both and at least the
larger); every other S goes to ``ops/attention.blockwise_attention``, and
each such call is logged once per shape and counted in
:func:`fallback_stats`, as in the JAX package. The rule exists for the
Pallas kernels' block divisibility; the CUDA kernels tile by 64 rows and
mask the ragged tile, so a CUDA tensor of any S goes through them and the
block pair is ignored.
"""

from __future__ import annotations

import ctypes
import logging
import math

import torch

from distributed_tensorflow_guide_tpu_torch.ops.attention import (
    blockwise_attention,
)

NEG_INF = -1e30  # the finite mask value of the reference kernels
DEFAULT_BLOCKS: tuple[int, int] = (128, 128)  # the JAX package's fallback
TILE = 64  # rows per tile of the CUDA kernels and of the plain versions
# The widest head dim any of the port's six kernels (K1-K6) takes; the
# model refuses a wider one where it meets the card (``Transformer``
# placed on CUDA). Flash pads a head dim that is not a multiple of 8.
MAX_HEAD_DIM = 128
KERNEL_SOURCE = "distributed_tensorflow_guide_tpu_torch/ops/csrc/flash_attention.cu"

LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_carry": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# the bound model (bytes each kernel must move, operations it must do)
# --------------------------------------------------------------------------

_FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8,
                   "flash_carry": 4}  # x hd


def visible_pairs(b: int, h: int, s: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through."""
    per_head = s * (s + 1) // 2 if causal else s * s
    return b * h * per_head


def flash_kernel_bytes(kernel: str, *, b: int, h: int, s: int, d: int,
                       dtype: torch.dtype) -> float:
    """Least device-memory traffic of one call: each input read once, each
    output written once. K1 reads q, k, v and writes O and the f32 LSE; K2
    reads q, k, v, dO, LSE and delta and writes dQ; K3 reads the same and
    writes dK and dV; K4 reads q, k, v and reads and writes the f32 carry
    (m, l and acc)."""
    t = b * s * h * d * dtype.itemsize
    rows = b * h * s * 4
    if kernel == "flash_carry":
        return float(3 * t + 4 * rows + 2 * b * h * s * d * 4)
    if kernel == "flash_fwd":
        return float(4 * t + rows)
    if kernel == "flash_dq":
        return float(5 * t + 2 * rows)
    if kernel == "flash_dkv":
        return float(6 * t + 2 * rows)
    raise ValueError(f"unknown kernel {kernel!r}")


def flash_kernel_flops(kernel: str, *, b: int, h: int, s: int, d: int,
                       causal: bool) -> float:
    """Operations of one call: 2 * hd per visible pair for each of the
    kernel's products (K1 and K4: Q K^T and P V; K2: + dO V^T and dS K in
    place of P V; K3: Q K^T, dO V^T, P^T dO, dS^T Q). For K4, ``causal`` is
    the visit's ``diag``."""
    return float(_FLOPS_PER_PAIR[kernel] * d
                 * visible_pairs(b, h, s, causal))


# --------------------------------------------------------------------------
# plain versions (what the CPU runs, and what the kernels are held to)
# --------------------------------------------------------------------------


def _heads_first(x):
    """(B, S, H, D) any dtype -> (B, H, S, D) float32."""
    return x.float().transpose(1, 2)


def _operand(x, dtype):
    """``x`` rounded to the input dtype, as the kernels round the f32 P and
    dS before the product that follows (a no-op for float32 inputs)."""
    return x.to(dtype).float()


def _masked_scores(q, k, scale, causal, q0, k0):
    """scale * q k^T for rows [q0, q0 + Sq) against keys [k0, k0 + Sk),
    causal-masked with NEG_INF: the one definition every plain version
    uses, as ``_masked_scores`` is for the Pallas kernels."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        q_pos = q0 + torch.arange(q.shape[-2], device=q.device)
        k_pos = k0 + torch.arange(k.shape[-2], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full_like(s, NEG_INF))
    return s


def carry_init(b: int, h: int, s: int, d: int, device=None):
    """A fresh carry (m, l, acc): (B, H, S) f32 at NEG_INF, (B, H, S) f32
    zeros and (B, H, S, D) f32 zeros."""
    return (torch.full((b, h, s), NEG_INF, device=device),
            torch.zeros((b, h, s), device=device),
            torch.zeros((b, h, s, d), device=device))


def flash_carry_step_plain(q, k, v, m, l, acc, scale: float, diag: bool):
    """K4's function: the carry (m, l (B, H, S), acc (B, H, S, D), f32)
    after one visit of the KV shard (k, v) to the query shard q, all
    (B, S_loc, H, D); ``diag`` masks causally within the aligned shard.
    The online softmax over KV tiles of ``TILE`` keys, with the masked
    entries zeroed (``s <= NEG_INF / 2``); l sums the f32 P, P V takes P
    in q's dtype. Returns new tensors."""
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    S = kf.shape[2]
    m, l = m[..., None], l[..., None]
    for k0 in range(0, S, TILE):
        s = _masked_scores(qf, kf[:, :, k0:k0 + TILE], scale, diag, 0, k0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_operand(p, q.dtype),
                                         vf[:, :, k0:k0 + TILE])
        m = m_new
    return m[..., 0], l[..., 0], acc


def carry_finalize(m, l, acc):
    """(out (B, S, H, D) f32, lse (B, H, S) f32): the carry normalised
    once, after the last visit; a row that saw no key (l = 0) gives 0 and
    keeps its m as its LSE (``safe_l``)."""
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / safe_l[..., None]).transpose(1, 2).contiguous()
    return out, (m + torch.log(safe_l)).contiguous()


def flash_fwd_plain(q, k, v, scale: float, causal: bool):
    """K1's function: (out (B, S, H, D) in q's dtype, lse (B, H, S) f32):
    one visit of the whole sequence from a fresh carry, then the
    normaliser."""
    B, S, H, D = q.shape
    carry = carry_init(B, H, S, D, device=q.device)
    out, lse = carry_finalize(*flash_carry_step_plain(q, k, v, *carry, scale,
                                                      causal))
    return out.to(q.dtype), lse


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float,
                       causal: bool):
    """K2's function: dQ = sum over KV tiles of dS K, with P = exp(s - lse)
    recomputed and dS = P (dO V^T - delta) scale, taken in q's dtype.
    Returns (B, S, H, D) in q's dtype."""
    qf, kf, vf, dof = (_heads_first(x) for x in (q, k, v, do))
    S = qf.shape[2]
    lse_, delta_ = lse[..., None], delta[..., None]
    dq = torch.zeros_like(qf)
    for k0 in range(0, S, TILE):
        kb, vb = kf[:, :, k0:k0 + TILE], vf[:, :, k0:k0 + TILE]
        p = torch.exp(_masked_scores(qf, kb, scale, causal, 0, k0) - lse_)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta_) * scale
        dq = dq + torch.matmul(_operand(ds, q.dtype), kb)
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float,
                        causal: bool):
    """K3's function: per key, summed over query tiles, dV = P^T dO and
    dK = dS^T Q, P and dS taken in q's dtype. Returns (dk, dv), (B, S, H, D)
    in k's and v's dtypes."""
    qf, kf, vf, dof = (_heads_first(x) for x in (q, k, v, do))
    S = qf.shape[2]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, S, TILE):
        qb, dob = qf[:, :, q0:q0 + TILE], dof[:, :, q0:q0 + TILE]
        lse_b = lse[:, :, q0:q0 + TILE, None]
        delta_b = delta[:, :, q0:q0 + TILE, None]
        p = torch.exp(_masked_scores(qb, kf, scale, causal, q0, 0) - lse_b)
        dv = dv + torch.matmul(_operand(p, q.dtype).transpose(-1, -2), dob)
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        ds = p * (dp - delta_b) * scale
        dk = dk + torch.matmul(_operand(ds, q.dtype).transpose(-1, -2), qb)
    return (dk.to(k.dtype).transpose(1, 2).contiguous(),
            dv.to(v.dtype).transpose(1, 2).contiguous())


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _lib():
    from distributed_tensorflow_guide_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_dtg_bound", False):
        vp, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_longlong)
        tail = [ll] * 3 + [i] * 4 + [f, i, i, vp]
        lib.dtg_flash_fwd.argtypes = [vp] * 5 + tail
        lib.dtg_flash_bwd_dq.argtypes = [vp] * 7 + tail
        lib.dtg_flash_bwd_dkv.argtypes = [vp] * 8 + tail
        lib.dtg_flash_carry.argtypes = [vp] * 6 + tail
        for fn in (lib.dtg_flash_fwd, lib.dtg_flash_bwd_dq,
                   lib.dtg_flash_bwd_dkv, lib.dtg_flash_carry):
            fn.restype = ctypes.c_int
        lib._dtg_bound = True
    return lib


def _pad_hd(t, hdp: int):
    """``t`` with its last dim zero-padded to ``hdp`` (itself if it fits)."""
    pad = hdp - t.shape[-1]
    return t if pad == 0 else torch.nn.functional.pad(t, (0, pad))


def _padded_head_dim(hd: int) -> int:
    """The head dim the flash kernels run at: ``hd`` rounded up to a
    multiple of 8 (zero columns change no score and no output column)."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernels take 1 to "
                         f"{MAX_HEAD_DIM}")
    return -(-hd // 8) * 8


def _kernel_layout(q, k, v):
    """q, k, v as the kernels take them: one shared stride triple over
    (B, S, H) with the head dim contiguous and a multiple of 8 (zero-padded
    where it is not), 16-byte aligned rows (the bf16 kernels build their
    TMA tensor maps from these strides). Column slices of one qkv tensor
    qualify as they are; anything else, a contiguous tensor that starts
    off a 16-byte boundary included, is copied into fresh contiguous
    storage. Returns (q, k, v, (sb, ss, sh))."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernels take float32/bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must share one shape")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    hdp = _padded_head_dim(q.shape[-1])
    q, k, v = (_pad_hd(t, hdp) for t in (q, k, v))
    per_vec = 16 // q.dtype.itemsize
    strides = q.stride()

    def fits(t):
        return (t.stride() == strides and t.stride(-1) == 1
                and all(st % per_vec == 0 for st in t.stride()[:3])
                and t.data_ptr() % 16 == 0)

    if not all(fits(t) for t in (q, k, v)):
        q, k, v = (t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        strides = q.stride()
        if not all(fits(t) for t in (q, k, v)):
            raise ValueError("q, k and v must start on 16-byte boundaries "
                             "(the kernels load them by TMA)")
    return q, k, v, strides[:3]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rows(name, t, shape, device):
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 {shape} on "
                         f"{device}")


_KERNEL_CODES = {-1: "no kernel takes these dtypes and sizes",
                 9001: "libcuda has no cuTensorMapEncodeTiled",
                 9002: "libcuda refused the TMA tensor map",
                 9003: "the compiled kernel's registers do not hold its "
                       "setmaxnreg plan"}


def kernel_error(rc: int) -> str:
    """What a kernel library's nonzero return code means."""
    return _KERNEL_CODES.get(rc, f"cuda error {rc}")


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{kernel_error(rc)}")


def flash_fwd(q, k, v, *, scale: float, causal: bool):
    """K1: (out (B, S, H, D) contiguous in q's dtype, lse (B, H, S) f32).
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    hd = q.shape[-1]
    q, k, v, (sb, ss, sh) = _kernel_layout(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = _lib().dtg_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), sb, ss, sh, B, S, H, D, scale, int(causal),
        _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return _unpad(out, hd), lse


def _unpad(t, hd: int):
    """A kernel's output at the caller's head dim, contiguous."""
    return t if t.shape[-1] == hd else t[..., :hd].contiguous()


def _bwd_operands(q, k, v, do, lse, delta):
    if do.shape != q.shape or do.device != q.device:
        raise ValueError("dO must match q's shape and device")
    q, k, v, strides = _kernel_layout(q, k, v)
    B, S, H, D = q.shape
    do = _pad_hd(do.to(q.dtype), D).contiguous()
    for name, t in (("lse", lse), ("delta", delta)):
        _check_rows(name, t, (B, H, S), q.device)
    return q, k, v, do, strides


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """K2: dQ (B, S, H, D) contiguous in q's dtype. ``lse`` and ``delta``
    are (B, H, S) f32. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    hd = q.shape[-1]
    q, k, v, do, (sb, ss, sh) = _bwd_operands(q, k, v, do, lse, delta)
    B, S, H, D = q.shape
    dq = torch.empty_like(do)
    rc = _lib().dtg_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), sb, ss, sh, B, S,
        H, D, scale, int(causal), _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_dq"] += 1
    return _unpad(dq, hd)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """K3: (dK, dV), each (B, S, H, D) contiguous in q's dtype. CPU tensors
    take the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    hd = q.shape[-1]
    q, k, v, do, (sb, ss, sh) = _bwd_operands(q, k, v, do, lse, delta)
    B, S, H, D = q.shape
    dk = torch.empty_like(do)
    dv = torch.empty_like(do)
    rc = _lib().dtg_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), sb,
        ss, sh, B, S, H, D, scale, int(causal), _DTYPE_CODE[q.dtype],
        _stream(q))
    _raise_on(rc, "flash_bwd_dkv")
    LAUNCHES["flash_dkv"] += 1
    return _unpad(dk, hd), _unpad(dv, hd)


def flash_carry_step(q, k, v, m, l, acc, *, scale: float, diag: bool):
    """K4: one ring visit, merging the KV shard (k, v) into the carry of the
    query shard q. q, k, v: (B, S_loc, H, D), K1's layout and dtypes; m, l:
    (B, H, S_loc) f32; acc: (B, H, S_loc, D) f32, un-normalised; ``diag``:
    causal masking within the aligned shard (the caller skips the dead
    visits). Returns the carry: on the card the same three tensors, updated
    in place (the ring's forward runs without autograd); on the CPU new
    tensors from the plain version."""
    if q.device.type == "cpu":
        return flash_carry_step_plain(q, k, v, m, l, acc, scale, diag)
    if q.device.type != "cuda":
        raise ValueError(f"flash_carry_step: unsupported device {q.device}")
    hd = q.shape[-1]
    q, k, v, (sb, ss, sh) = _kernel_layout(q, k, v)
    B, S, H, D = q.shape
    _check_rows("m", m, (B, H, S), q.device)
    _check_rows("l", l, (B, H, S), q.device)
    _check_rows("acc", acc, (B, H, S, hd), q.device)
    acc_k = _pad_hd(acc, D).contiguous()  # acc itself unless hd was padded
    rc = _lib().dtg_flash_carry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc_k.data_ptr(), sb, ss, sh, B, S, H, D, scale,
        int(diag), _DTYPE_CODE[q.dtype], _stream(q))
    _raise_on(rc, "flash_carry_step")
    if acc_k is not acc:
        acc.copy_(acc_k[..., :hd])
    LAUNCHES["flash_carry"] += 1
    return m, l, acc


# --------------------------------------------------------------------------
# the differentiable call
# --------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """K1 forward; K2 + K3 backward. Saved: q, k, v, out and the compact
    (B, H, S) f32 LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        scale = 1.0 / math.sqrt(q.shape[-1])
        out, lse = flash_fwd(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()  # (B, H, S)
        kw = dict(scale=ctx.scale, causal=ctx.causal)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
        return dq, dk, dv, None


def supported(s: int, d: int, blk_q: int | None = None,
              blk_k: int | None = None) -> bool:
    """Shapes that take the fused path on the CPU (the JAX package's
    rule); CPU callers fall back to ``blockwise_attention`` otherwise."""
    if blk_q is None:
        blk_q = DEFAULT_BLOCKS[0]
    if blk_k is None:
        blk_k = DEFAULT_BLOCKS[1]
    return s % blk_q == 0 and s % blk_k == 0 and s >= max(blk_q, blk_k)


_FALLBACKS: dict[tuple, int] = {}


def fallback_stats() -> dict[tuple, int]:
    """(origin, s, d, blk_q, blk_k) -> number of fused -> blockwise
    fallbacks."""
    return dict(_FALLBACKS)


def _note_fallback(s: int, d: int, blk_q: int, blk_k: int, *,
                   origin: str = "flash_attention",
                   msg: str | None = None) -> None:
    key = (origin, s, d, blk_q, blk_k)
    first = key not in _FALLBACKS
    _FALLBACKS[key] = _FALLBACKS.get(key, 0) + 1
    if first:
        logging.getLogger("dtg.ops.flash").warning(msg or (
            f"flash_attention: seq_len {s} not a multiple of block "
            f"({blk_q}, {blk_k}); falling back to the blockwise path "
            "(slower). Pad the sequence or adjust blk_q/blk_k."))


def flash_attention(q, k, v, *, causal: bool = False,
                    blk_q: int | None = None, blk_k: int | None = None):
    """Fused attention, layout (B, S, H, D) -> (B, S, H, D) in q's dtype.

    Softmax scale 1/sqrt(D). Differentiable through the K2/K3 backward
    kernels. On the CPU, ``blk_q``/``blk_k`` pin the block pair of the
    JAX package's fallback rule (default ``DEFAULT_BLOCKS``); every other
    device takes the kernels at any S.
    """
    if q.device.type == "cpu":
        s, d = q.shape[1], q.shape[-1]
        pin = (blk_q if blk_q is not None else DEFAULT_BLOCKS[0],
               blk_k if blk_k is not None else DEFAULT_BLOCKS[1])
        if not supported(s, d, *pin):
            _note_fallback(s, d, *pin)
            return blockwise_attention(q, k, v, causal=causal)
    return _Flash.apply(q, k, v, causal)
