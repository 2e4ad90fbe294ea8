"""Sequence (context) parallelism: ring attention and Ulysses over the
mesh's ``context`` axis.

Every rank holds one shard of the sequence, (B, S_loc, H, D); the global
sequence is the shards in axis order. Every rank of the axis must call,
in the same order, and call backward: the collectives inside are matched
across ranks.

* **Ring attention** (Liu et al. 2023): each rank merges the KV shard it
  holds into the online-softmax state of its query shard, then passes the
  KV shard one hop around the ring (``collectives.ppermute``); after ``n``
  visits every query shard has seen every KV shard. Causality over equal,
  aligned shards is one of three cases per visit: the visiting shard is
  this rank's own (``diag``: causal within the shard), lies before it
  (full) or after it (dead).

  - ``impl="kernel"`` (the JAX package's ``"pallas"``): the forward runs
    K4 (``ops/flash_attention.flash_carry_step``) per live visit and
    skips the dead ones; the backward is written by hand with the JAX
    package's Q-side rotation: k and v stay home while q, the output
    cotangent, the LSE, delta and the travelling dq partial rotate, and
    K2 + K3 run per live visit. Each visit's dq, dk and dv come out of K2
    and K3 in the input dtype and are summed in f32, as in the JAX
    package. Both directions keep its hop count: n hops of k and v forward
    (the last one's result is not used) and n hops of the five Q-side
    tensors backward.
  - ``impl="blockwise"`` (the JAX package's ``"xla"``): plain PyTorch
    ``ops/attention.block_update`` per visit with the mask applied to the
    dead visits too, differentiated by autograd through ``ppermute``.
  - ``impl="auto"``: CUDA tensors take ``"kernel"``; CPU tensors resolve
    as the JAX package's ``RING_AUTO_IMPL`` does (``"xla"``, here
    ``"blockwise"``), so the parity tests pin the same choice.

  On CPU tensors ``"kernel"`` keeps the JAX package's refusal of an
  ``S_loc`` off a multiple of 128; the CUDA kernels mask the ragged tile
  and take any ``S_loc``. The JAX package's opt-in warning for
  ``impl="pallas"`` and the ratio table it cites
  (``RING_PALLAS_LAST_MEASURED``) are TPU measurements and are not carried.

* **Ulysses** (Jacobs et al. 2023): ``all_to_all`` reshards sequence ->
  heads, attention runs over the full sequence on ``H / n`` heads, and a
  second ``all_to_all`` reshards back.
"""

from __future__ import annotations

import math

import torch

from distributed_tensorflow_guide_tpu_torch.collectives import collectives as cc
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    AxisGroup,
    Mesh,
    resolve_axis,
)
from distributed_tensorflow_guide_tpu_torch.ops import attention as A
from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as F

# what impl="auto" resolves to for CPU tensors: the JAX package's
# RING_AUTO_IMPL ("xla"), whose counterpart here is "blockwise"
RING_AUTO_IMPL = "blockwise"


def _ring(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def resolve_ring_impl(impl: str, device: torch.device) -> str:
    """``impl`` as ``ring_attention`` runs it on tensors of ``device``:
    "auto" is "kernel" on a card and ``RING_AUTO_IMPL`` elsewhere."""
    if impl not in ("auto", "kernel", "blockwise"):
        raise ValueError(f"unknown ring impl {impl!r}")
    if impl != "auto":
        return impl
    return "kernel" if torch.device(device).type == "cuda" else RING_AUTO_IMPL


def ring_attention(q, k, v, *, axis: str = "context", causal: bool = False,
                   impl: str = "auto", mesh: Mesh | None = None):
    """Sequence-sharded attention over the ``axis`` ring of ``mesh`` (or of
    the mesh entered with ``with mesh:``). Per-rank (B, S_loc, H, D) in and
    out, in q's dtype."""
    impl = resolve_ring_impl(impl, q.device)
    ax = resolve_axis(axis, mesh)
    s_local, d = q.shape[1], q.shape[-1]
    if impl == "kernel":
        if q.device.type == "cpu" and not F.supported(s_local, d):
            raise ValueError(
                f"impl='kernel' on CPU tensors needs a per-rank sequence "
                f"length divisible by 128 (got S_local={s_local}), as the "
                "JAX package's impl='pallas'; use impl='blockwise' or pad "
                "the sequence")
        return _RingKernel.apply(q, k, v, ax, causal)
    return _ring_blockwise(q, k, v, ax, causal)


def _ring_blockwise(q, k, v, ax: AxisGroup, causal: bool):
    n, my = ax.size, ax.index
    s_local = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    m, l, o = A.init_carry(q.shape, device=q.device)
    q_pos = my * s_local + torch.arange(s_local, device=q.device)
    k_cur, v_cur, src = k, v, my
    for _ in range(n):
        mask = None
        if causal:
            kv_pos = src * s_local + torch.arange(s_local, device=q.device)
            mask = (q_pos[:, None] >= kv_pos[None, :])[None, None]
        m, l, o = A.block_update(qf, k_cur.float(), v_cur.float(), m, l, o,
                                 scale=scale, mask=mask)
        # the shard received came from the previous rank: its global
        # offset goes down by one each hop
        k_cur = cc.ppermute(k_cur, ax, _ring(n))
        v_cur = cc.ppermute(v_cur, ax, _ring(n))
        src = (src - 1) % n
    return A.finalize(m, l, o).to(q.dtype)


def _ring_steps_fwd(q, k, v, ax: AxisGroup, causal: bool, scale: float):
    """The ring forward over K4: (out in q's dtype, lse (B, H, S_loc))."""
    n, my = ax.size, ax.index
    B, S, H, D = q.shape
    m, l, acc = F.carry_init(B, H, S, D, device=q.device)
    k_cur, v_cur, src = k, v, my
    for _ in range(n):
        if not causal or src <= my:  # src > my is dead: skipped
            m, l, acc = F.flash_carry_step(q, k_cur, v_cur, m, l, acc,
                                           scale=scale,
                                           diag=causal and src == my)
        k_cur = cc.ppermute(k_cur, ax, _ring(n))
        v_cur = cc.ppermute(v_cur, ax, _ring(n))
        src = (src - 1) % n
    out, lse = F.carry_finalize(m, l, acc)
    return out.to(q.dtype), lse


class _RingKernel(torch.autograd.Function):
    """K4 forward; hand-written Q-side backward over K2 and K3. Saved: q,
    k, v, out and the (B, H, S_loc) f32 LSE."""

    @staticmethod
    def forward(ctx, q, k, v, ax, causal):
        scale = 1.0 / math.sqrt(q.shape[-1])
        out, lse = _ring_steps_fwd(q, k, v, ax, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ax, ctx.causal, ctx.scale = ax, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ax, causal = ctx.ax, ctx.causal
        n, my = ax.size, ax.index
        g = g.to(q.dtype).contiguous()
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
        q_cur, g_cur, lse_cur = q, g, lse
        delta_cur = delta.contiguous()
        dq_cur = torch.zeros(q.shape, device=q.device)
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        src_q = my
        for _ in range(n):
            # the local kv shard meets the visiting q shard of src_q:
            # src_q == my is the diagonal, src_q > my full, src_q < my dead
            if not causal or src_q >= my:
                kw = dict(scale=ctx.scale, causal=causal and src_q == my)
                args = (q_cur, k, v, g_cur, lse_cur, delta_cur)
                dq_cur = dq_cur + F.flash_bwd_dq(*args, **kw).float()
                dk_s, dv_s = F.flash_bwd_dkv(*args, **kw)
                dk += dk_s.float()
                dv += dv_s.float()
            q_cur = cc.ppermute(q_cur, ax, _ring(n))
            g_cur = cc.ppermute(g_cur, ax, _ring(n))
            lse_cur = cc.ppermute(lse_cur, ax, _ring(n))
            delta_cur = cc.ppermute(delta_cur, ax, _ring(n))
            dq_cur = cc.ppermute(dq_cur, ax, _ring(n))
            src_q = (src_q - 1) % n
        return (dq_cur.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None,
                None)


def ulysses_attention(q, k, v, *, axis: str = "context",
                      causal: bool = False, impl: str = "auto",
                      mesh: Mesh | None = None):
    """Ulysses: all_to_all seq -> heads, full-sequence attention on a head
    shard, all_to_all heads -> seq. Per-rank (B, S_loc, H, D) in and out;
    the axis size must divide H.

    ``impl``: "flash" runs ``ops/flash_attention.flash_attention`` (K1-K3
    on CUDA tensors at any S; on CPU tensors it needs the JAX package's
    block rule, S_global a multiple of 128, and raises otherwise), "dense"
    plain attention, "auto" flash where it runs and dense otherwise.
    """
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"unknown ulysses impl {impl!r}")
    ax = resolve_axis(axis, mesh)
    n, h = ax.size, q.shape[2]
    if h % n:
        raise ValueError(f"context size {n} must divide num_heads {h} "
                         "(each rank takes H/n heads after the all_to_all)")

    def to_heads(x):  # (B, S/n, H, D) -> (B, S, H/n, D)
        return cc.all_to_all(x, ax, split_axis=2, concat_axis=1)

    def to_seq(x):  # (B, S, H/n, D) -> (B, S/n, H, D)
        return cc.all_to_all(x, ax, split_axis=1, concat_axis=2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    s_global, d = qh.shape[1], qh.shape[-1]
    fits = q.device.type != "cpu" or F.supported(s_global, d)
    if impl == "flash" and not fits:
        raise ValueError(
            f"impl='flash' on CPU tensors needs a global sequence length "
            f"divisible by 128 (got {s_global}); use impl='dense' or pad "
            "the sequence")
    if impl == "flash" or (impl == "auto" and fits):
        out = F.flash_attention(qh, kh, vh, causal=causal)
    else:
        out = A.dense_attention(qh, kh, vh, causal=causal)
    return to_seq(out)
