"""Chunked fused next-token cross-entropy: the LM head without full logits.

The head matmul, an online log-sum-exp, the target gather and the
gradient of the logits (``softmax - onehot``) run per VOCAB CHUNK, so the
largest loss intermediate in the forward or the backward is one
``(N, chunk)`` f32 tile; a ``(N, V)`` tensor never exists.

* :class:`_FusedNLL` (an ``autograd.Function``) keeps only
  ``(x, kernel, targets, lse)`` for the backward, which re-runs the chunk
  matmuls and emits ``dz = softmax - onehot`` tile by tile into the two
  gradient matmuls.
* The matmuls take operands in the ACTIVATION dtype and accumulate in f32
  (``_dot_f32``): bf16 activations give bf16 operands and f32 results.
* One implementation serves tp = 1 and vocab parallelism: with ``axis``
  each rank runs the same chunk loop over its ``V / tp`` shard of the
  kernel with global target ids (offset ``axis_index * V / tp``); the
  forward assembles ``lse`` and the target logit with a pmax and two psums
  (Megatron's scalar-field triple), and the backward psums ``dx``, while
  ``dW`` stays on its shard. Under Megatron sequence parallelism the
  input's own backward (a reduce-scatter) sums ``dx``: ``sum_dx=False``
  leaves it to it.

The chunk width is a tuned value (``ops/autotune.py``'s ``fused_ce``
entry, keyed on N, d, V_local and the activation dtype): ``chunk=None``
takes the table's entry through the online front door (an in-situ sweep
of the forward and backward with online tuning on), else
``DEFAULT_CE_CHUNK`` clipped to V_local; on the CPU always the default.
Under a vocab-parallel ``axis`` the axis's first rank decides and
broadcasts it, so every rank runs the same chunk loop.

This is plain PyTorch, as the JAX package's version is plain jnp: the
chunk matmuls go to the library's GEMMs.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import resolve_axis
from distributed_tensorflow_guide_tpu_torch.ops import autotune

DEFAULT_CE_CHUNK = autotune.DEFAULT_CE_CHUNK  # the JAX package's default


def resolve_fused_ce(setting, *, vocab_size: int | None = None,
                     platform: str | None = None) -> bool:
    """Resolve ``fused_ce="auto"|True|False`` to a bool.

    ``auto`` is on for a CUDA device (where the JAX package turns it on for
    a TPU) with a vocab larger than one default chunk, and off on the
    CPU. ``platform`` is a device type ("cuda", "cpu"); None means "cuda"
    when a card is present."""
    if isinstance(setting, bool):
        return setting
    s = str(setting).lower()
    if s in ("on", "true", "1"):
        return True
    if s in ("off", "false", "0"):
        return False
    if s != "auto":
        raise ValueError(
            f"fused_ce must be 'auto', on/True or off/False, got {setting!r}")
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform != "cuda":
        return False
    return vocab_size is None or vocab_size > DEFAULT_CE_CHUNK


def _chunk_bounds(v: int, chunk: int) -> list[tuple[int, int]]:
    """[lo, hi) column windows; the last one may be ragged."""
    return [(lo, min(lo + chunk, v)) for lo in range(0, v, chunk)]


def _dot_f32(a, b, ct):
    """a @ b with operands in the compute dtype ``ct`` and an f32 result.
    On the card a bf16 product accumulates in f32 and is returned in f32
    (``out_dtype``); elsewhere the bf16 operands are widened to f32 first,
    which gives the same products."""
    a, b = a.to(ct), b.to(ct)
    if ct == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FusedNLL(torch.autograd.Function):
    """SUM of the NLL over the N rows of ``x`` (N, D) against ``kernel``
    (D, V_local) and ``targets`` (N,); ``ax`` the vocab-parallel axis or
    None; ``sum_dx``: psum ``dx`` over ``ax`` in the backward."""

    @staticmethod
    def forward(ctx, x, kernel, targets, chunk, ax, sum_dx):
        n = x.shape[0]
        ct = x.dtype
        offset = ax.index * kernel.shape[1] if ax is not None else 0
        targets = targets - offset  # ids local to this shard
        m = torch.full((n,), -torch.inf, device=x.device)
        s = torch.zeros((n,), device=x.device)
        zt = torch.zeros((n,), device=x.device)
        rows = torch.arange(n, device=x.device)
        for lo, hi in _chunk_bounds(kernel.shape[1], chunk):
            z = _dot_f32(x, kernel[:, lo:hi], ct)  # (n, ck)
            m_new = torch.maximum(m, z.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                z - m_new[:, None]).sum(dim=-1)
            m = m_new
            t = targets - lo
            ok = (t >= 0) & (t < hi - lo)
            zt = zt + torch.where(ok, z[rows, t.clamp(0, hi - lo - 1)],
                                  torch.zeros_like(zt))
        if ax is not None:
            # max for stability, sum of exponentials, the target logit
            # (exactly one shard owns it)
            mg = cc.pmax(m, ax)
            s = cc.psum(s * torch.exp(m - mg), ax)
            zt = cc.psum(zt, ax)
            m = mg
        lse = torch.log(s) + m
        ctx.save_for_backward(x, kernel, targets, lse)
        ctx.chunk, ctx.ax, ctx.sum_dx = chunk, ax, sum_dx
        return (lse - zt).sum()

    @staticmethod
    def backward(ctx, g):
        x, kernel, targets, lse = ctx.saved_tensors
        ct = x.dtype
        g32 = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(kernel.shape, dtype=torch.float32, device=x.device)
        for lo, hi in _chunk_bounds(kernel.shape[1], ctx.chunk):
            w_c = kernel[:, lo:hi]
            p = _dot_f32(x, w_c, ct)  # the recomputed logits, in place:
            p.sub_(lse[:, None]).exp_()  # softmax
            t = targets - lo
            ok = (t >= 0) & (t < hi - lo)
            # - onehot: one element per row, 0 subtracted where the target
            # lies in another chunk
            p.scatter_add_(1, t.clamp(0, hi - lo - 1)[:, None],
                           -ok.float()[:, None])
            dz = (p * g32).to(ct)
            del p
            dx += _dot_f32(dz, w_c.t(), ct)
            dw[:, lo:hi] = _dot_f32(x.t(), dz, ct)
        if ctx.ax is not None and ctx.sum_dx:
            # dx sums every shard's part; dW is the shard's own gradient
            dx = cc.psum(dx, ctx.ax)
        return dx.to(x.dtype), dw.to(kernel.dtype), None, None, None, None


def fused_cross_entropy(x, kernel, targets, *, chunk: int | None = None,
                        axis: str | None = None, reduction: str = "mean",
                        sum_dx: bool = True):
    """Chunked cross-entropy ``-log softmax(x @ kernel)[targets]``.

    x: ``(..., D)`` activations (post-LN); kernel: ``(D, V_local)``, the
    full vocabulary, or with ``axis`` this rank's shard of it along that
    axis of the active mesh (``with mesh:``); targets: ``(...)`` GLOBAL
    int ids, the leading shape of ``x``. Returns the mean
    (default) or sum NLL as a 0-d f32 tensor, the same on every rank of
    ``axis``; no ``(N, V)`` tensor is live in the forward or the backward.
    ``chunk=None`` takes the tuned chunk (:func:`resolve_chunk`).
    ``sum_dx=False`` (with ``axis``) leaves ``x``'s gradient as this
    shard's part, for an ``x`` whose own backward sums it.
    """
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got "
                         f"{reduction!r}")
    if tuple(x.shape[:-1]) != tuple(targets.shape):
        raise ValueError(
            f"targets shape {tuple(targets.shape)} must match x leading "
            f"shape {tuple(x.shape[:-1])}")
    d = x.shape[-1]
    if kernel.ndim != 2 or kernel.shape[0] != d:
        raise ValueError(
            f"kernel must be (D={d}, V), got {tuple(kernel.shape)}")
    x2 = x.reshape(-1, d)
    t1 = targets.reshape(-1).long()
    v = kernel.shape[1]
    ax = None if axis is None else resolve_axis(axis)
    if chunk is None:
        chunk = resolve_chunk(n=x2.shape[0], d=d, v=v, dtype=x.dtype,
                              device=x.device,
                              group=None if ax is None else ax.group)
    chunk = max(1, min(int(chunk), v))
    total = _FusedNLL.apply(x2, kernel, t1, chunk, ax, sum_dx)
    if reduction == "sum":
        return total
    return total / x2.shape[0]


def resolve_chunk(*, n: int, d: int, v: int, dtype, device,
                  group=None) -> int:
    """The vocab chunk of a fused-CE call over (``n``, ``d``) activations
    and a ``v``-column (local) head: the ``fused_ce`` table entry through
    ``autotune.ensure_tuned_online`` (with online tuning on and no entry,
    a sweep of :class:`_FusedNLL`'s forward and backward at this key),
    else ``DEFAULT_CE_CHUNK`` clipped to ``v``; the default on the CPU.
    ``group``: the vocab-parallel axis's process group, whose first rank
    decides for all."""
    return autotune.ensure_tuned_online(
        autotune.CE_KERNEL, n=n, d=d, v=v, dtype=dtype, device=device,
        group=group, iters=10)


def fused_next_token_loss(x, kernel, tokens, *, chunk: int | None = None,
                          axis: str | None = None,
                          reduction: str = "mean", sum_dx: bool = True):
    """Next-token LM loss from pre-head hidden states: positions ``:-1``
    predict tokens ``1:``."""
    return fused_cross_entropy(
        x[:, :-1], kernel, tokens[:, 1:], chunk=chunk, axis=axis,
        reduction=reduction, sum_dx=sum_dx)


def lint_contracts():
    """Contract for the fused-CE loss and gradient under the bf16 policy:
    every chunk product takes bf16 factors and sums in f32 (the card's
    ``torch.mm(..., out_dtype=f32)``, the CPU's widened factors), the
    log-sum-exp stays f32, and no f32 (N, V) logits tensor exists in the
    forward OR the backward (``vocab_rows=N`` keeps the (D, V) weight
    gradient out of scope)."""
    import numpy as np

    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        CostPin,
        CostSpec,
        ProgramContract,
    )
    from distributed_tensorflow_guide_tpu_torch.analysis.cost import (
        closed_forms,
    )

    N, D, V, CHUNK = 64, 32, 128, 32

    def _build(device):
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
        kernel = torch.from_numpy(
            (rng.standard_normal((D, V)) * 0.1).astype(np.float32))
        targets = torch.from_numpy(rng.randint(0, V, N)).to(device)
        x = x.to(device, torch.bfloat16).requires_grad_()
        kernel = kernel.to(device, torch.bfloat16).requires_grad_()

        def loss_and_grad(x, kernel, targets):
            loss = fused_cross_entropy(x, kernel, targets, chunk=CHUNK)
            return (loss, *torch.autograd.grad(loss, (x, kernel)))

        return loss_and_grad, (x, kernel, targets)

    return [
        ProgramContract(
            name="fused_ce_loss_grad",
            build=_build,
            policy="bf16",
            vocab_dim=V,
            vocab_rows=N,
            max_vocab_f32_elems=0,
            collectives={},  # single shard: no vocab-parallel psums
            sources=("distributed_tensorflow_guide_tpu_torch.ops.fused_ce",),
            cost=CostSpec(
                pins=(
                    # forward, backward recompute, dx, dW: four passes of
                    # the logit product (the recompute is the price of
                    # never holding the logits)
                    CostPin("flops", 4 * 2.0 * N * D * V,
                            note="4 logit-product passes incl. the "
                                 "backward recompute"),
                    CostPin("hbm_bytes",
                            lambda: closed_forms().fused_ce_trace_bytes(
                                N, D, V, CHUNK),
                            note="fusion-boundary chunk traffic model"),
                ),
                # 63,308 observed on the CPU census: x, the kernel, the
                # f32 (N, chunk) tiles, dx and dW at once
                max_peak_live_bytes=65536),
            notes="bf16 product factors, f32 sums, no full logits"),
    ]
