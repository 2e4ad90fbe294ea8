"""Quantisation across the stack: weight-only decode, int8 and fp8
training matmuls, and the int8-compressed gradient all-reduce.

The JAX package's ``ops/quant.py`` in PyTorch. Three primitives:

* **Weight-only int8 / int4 / fp8 serving** (:func:`quantize_channelwise`,
  :func:`wq_matmul`, behind ``TransformerConfig.weight_dtype``): one
  symmetric f32 scale per OUTPUT column, ``where(amax > 0, amax / qmax,
  1)``, so a zero column dequantises to exact zeros; int4 packs two
  nibbles a byte (:func:`pack_int4`); fp8 stores e4m3 values on the same
  scale contract. The scale multiplies the product's output columns,
  ``(x @ q) * scale``, in the reference's order. Unlike XLA, which folds
  the widening convert into the product's read, PyTorch materialises the
  widened kernel at every call (``q.to(dtype)``): a fused W8A16 product
  is perf work for later (ROADMAP).
* **AQT-style training matmuls** (:func:`int8_ste_dot`,
  :func:`fp8_ste_dot`, behind the ``int8`` / ``fp8`` precision presets):
  per-TENSOR scales re-derived from each step's values, the product int8
  x int8 -> int32 (e4m3 x e4m3 -> f32 for fp8), the dequant the product
  of the two scales, and a straight-through backward: the gradients of the
  unquantised product. On the card the int8 product is ``torch._int_mm``
  and the fp8 one ``torch._scaled_mm``, with the operands zero-padded to
  the shapes those take (zero rows and columns add nothing to an exact
  integer sum, nor to an f32 one); on the CPU the plain versions take any
  shape: exact integer sums, and e4m3 values widened to f32.
* **int8-compressed all-reduce** (:func:`int8_pmean`, the bucket
  transform of ``parallel/overlap.py``): one amax a call shared over the
  axis with a scalar ``pmax``, every rank quantising with ``127 // n``
  headroom so that the int8 sum cannot wrap, ONE int8 ``psum`` carrying
  every leaf; the wire then pays 1 byte an element plus 4 bytes of scale.

torch's cast to ``float8_e4m3fn`` may turn an overflow into NaN where the
reference's saturates: every fp8 cast here clamps to +-448 first
(:func:`to_fp8`).
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

__all__ = [
    "QMAX", "FP8_DTYPE", "FP8_MAX", "WQ_BITS_VALUES", "WQ_PROJECTIONS",
    "WQ_BANKS",
    "quantize_channelwise", "dequantize_channelwise", "pack_int4",
    "unpack_int4", "to_fp8", "wq_matmul", "wq_bank_matmul",
    "quantize_params", "int8_ste_dot", "fp8_ste_dot", "int8_pmean",
    "int8_encode", "int8_decode",
]

#: Symmetric integer grids: int8 clips at +-127 (-128 unused), int4 at +-7.
QMAX = {8: 127, 4: 7}
#: e4m3: the forward / inference fp8 format; scales map amax onto 448, the
#: largest finite e4m3fn value.
FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0
WQ_BITS_VALUES = (8, 4, "fp8")
#: ``TransformerConfig.weight_dtype`` -> ``bits``.
WQ_BITS = {"int8": 8, "int4": 4, "fp8": "fp8"}

#: The projections :func:`quantize_params` rewrites, by module name, each
#: mapped to the number of leading kernel axes the reference contracts
#: (its ``proj`` kernel is (heads, head_dim, d_model)). The port's
#: ``nn.Linear`` weights are already 2-D (d_out, d_in).
WQ_PROJECTIONS = {"qkv": 1, "proj": 2, "up": 1, "down": 1, "lm_head": 1}
#: The MoE expert banks (``models/transformer.MoEMLP``), by module name:
#: (E, d_in, d_out) weights whose leading axis is the expert, folded one
#: expert at a time into ``qkernel`` (E, d_in[/2], d_out) and ``scale``
#: (E, d_out), the layout :func:`wq_bank_matmul` takes. The router is in
#: neither table and stays f32.
WQ_BANKS = ("w_in", "w_out")


def _check_bits(bits) -> float:
    if bits == "fp8":
        return FP8_MAX
    if bits not in QMAX:
        raise ValueError(
            f"bits must be one of {sorted(QMAX)} or 'fp8', got {bits!r}")
    return float(QMAX[bits])


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float) as e4m3, saturating at +-448 (the reference's cast
    saturates; torch's may give NaN)."""
    return t.float().clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)


def quantize_channelwise(w: torch.Tensor, bits=8):
    """Per-output-column symmetric quantisation of a (d_in, d_out) kernel:
    ``(values, f32 scale (d_out,))``; int8 values for 8 and 4 bits, e4m3
    for ``"fp8"``. Round half to even (``torch.round``, as ``jnp.round``),
    so the values and scales are the reference's bits."""
    qmax = _check_bits(bits)
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    if bits == "fp8":
        return to_fp8(wf / scale[None, :]), scale
    values = torch.clamp(torch.round(wf / scale[None, :]), -qmax, qmax)
    return values.to(torch.int8), scale


def dequantize_channelwise(q: torch.Tensor, scale: torch.Tensor
                           ) -> torch.Tensor:
    """The unfused dequantisation: a test oracle."""
    return q.float() * scale[None, :]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Two int4 values (int8 storage, [-7, 7]) a byte along axis 0: row
    2i in the low nibble, row 2i+1 in the high one of packed row i,
    uint8."""
    if q.shape[0] % 2:
        raise ValueError(
            f"pack_int4 needs an even leading axis, got {tuple(q.shape)}")
    u = q.to(torch.uint8) & 0xF  # two's-complement nibbles
    return (u[1::2] << 4) | u[0::2]


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: (2n, ...) int8 values in [-8, 7]
    from (n, ...) packed bytes."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=1).reshape(
        (2 * packed.shape[0],) + tuple(packed.shape[1:]))


def wq_matmul(x: torch.Tensor, qkernel: torch.Tensor, scale: torch.Tensor,
              *, bits=8, dtype=torch.float32) -> torch.Tensor:
    """``x @ dequant(qkernel)`` as ``(x @ q.to(dtype)) * scale``: ``x``
    (..., d_in), ``qkernel`` the stored (d_in[/2], d_out) kernel (int8,
    packed uint8 for 4 bits, e4m3), ``scale`` (d_out,) f32. The product
    runs at ``dtype`` and the f32 scale lands on its output columns. The
    widened kernel is written out (d_out, d_in), the layout ``F.linear``
    takes for ``nn.Linear`` weights, so the product is the one the bf16
    projections run."""
    _check_bits(bits)
    w = unpack_int4(qkernel) if bits == 4 else qkernel
    wt = torch.empty((w.shape[1], w.shape[0]), dtype=dtype,
                     device=w.device)
    wt.copy_(w.t())
    y = torch.nn.functional.linear(x.to(dtype), wt)
    return (y.float() * scale).to(dtype)


def wq_bank_matmul(x: torch.Tensor, qbank: torch.Tensor,
                   scale: torch.Tensor, *, bits=8,
                   dtype=torch.float32) -> torch.Tensor:
    """:func:`wq_matmul` over a leading expert axis: ``x`` (E, ..., d_in),
    ``qbank`` (E, d_in[/2], d_out), ``scale`` (E, d_out); one expert at a
    time, so no more than one widened kernel is live."""
    _check_bits(bits)
    return torch.stack([
        wq_matmul(x[e], qbank[e], scale[e], bits=bits, dtype=dtype)
        for e in range(qbank.shape[0])])


def quantize_params(state_dict: Mapping[str, torch.Tensor], *, bits=8,
                    projections: Mapping | None = None
                    ) -> dict[str, torch.Tensor]:
    """An f32 ``Transformer`` state dict re-expressed for
    ``TransformerConfig.weight_dtype``: each projection weight
    (``<...>.{name}.weight`` for a name of :data:`WQ_PROJECTIONS`, an
    ``nn.Linear`` weight (d_out, d_in)) becomes ``{name}.qkernel``
    (d_in[/2], d_out) and ``{name}.scale`` (d_out,), the reference's
    layout and bits; each expert bank (:data:`WQ_BANKS`, (E, d_in,
    d_out)) becomes ``qkernel`` (E, d_in[/2], d_out) and ``scale`` (E,
    d_out), one expert at a time; biases and every other entry pass
    through. The input is left alone."""
    _check_bits(bits)
    names = WQ_PROJECTIONS if projections is None else projections
    out: dict[str, torch.Tensor] = {}
    for key, t in state_dict.items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight" and mod.rpartition(".")[2] in WQ_BANKS:
            qs, scales = zip(*(quantize_channelwise(k, bits=bits)
                               for k in t.detach()))
            q = torch.stack([pack_int4(x) if bits == 4 else x for x in qs])
            out[f"{mod}.qkernel"] = q
            out[f"{mod}.scale"] = torch.stack(scales)
        elif leaf == "weight" and mod.rpartition(".")[2] in names:
            q, scale = quantize_channelwise(t.detach().t(), bits=bits)
            out[f"{mod}.qkernel"] = pack_int4(q) if bits == 4 else q
            out[f"{mod}.scale"] = scale
        else:
            out[key] = t
    return out


# ---- training matmuls (straight-through) -----------------------------------


def _dynamic_quant(t: torch.Tensor):
    """One int8 scale for the whole operand, from this step's values."""
    amax = t.abs().amax().float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(t.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _dynamic_quant_fp8(t: torch.Tensor):
    """One fp8 scale for the whole operand: amax onto 448."""
    amax = t.abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return to_fp8(t.float() / scale), scale


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t.contiguous()
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:r, :c] = t
    return out


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) x int8 (k, n) -> exact int32 sums. On the card
    ``torch._int_mm``, which takes m > 16 and k, n multiples of 8: the
    operands are zero-padded to that and the result cut back. On the CPU
    an int32 product (exact: |q| <= 127)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {a.dtype}, "
                        f"{b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    mp, kp, np_ = max(_up(m, 8), 24), _up(k, 8), _up(n, 8)
    out = torch._int_mm(_pad2(a, mp, kp), _pad2(b, kp, np_))
    if out.dtype != torch.int32:
        raise RuntimeError(f"torch._int_mm gave {out.dtype}, not int32")
    return out[:m, :n]


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """e4m3 (m, k) x e4m3 (k, n) -> f32 sums. On the card
    ``torch._scaled_mm`` at unit scales with f32 output; every dim is
    zero-padded to a multiple of 16 and the second operand laid out
    column-major, as it takes them. On the CPU the values widened to f32
    (exact) and an f32 product."""
    if a.dtype != FP8_DTYPE or b.dtype != FP8_DTYPE:
        raise TypeError(f"fp8_mm takes e4m3 operands, got {a.dtype}, "
                        f"{b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    mp, kp, np_ = _up(m, 16), _up(k, 16), _up(n, 16)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    bt = _pad2(b.t(), np_, kp)  # (n, k) row-major = (k, n) column-major
    out = torch._scaled_mm(_pad2(a, mp, kp), bt.t(), scale_a=one,
                           scale_b=one, out_dtype=torch.float32)
    return out[:m, :n]


def _ste_grads(x, w, g):
    """The straight-through backward: the gradients of ``x @ w`` at f32,
    cast back to the operands' dtypes."""
    gf = g.float()
    dx = (gf @ w.float().t()).to(x.dtype)
    dw = (x.reshape(-1, x.shape[-1]).float().t()
          @ gf.reshape(-1, gf.shape[-1])).to(w.dtype)
    return dx, dw


class _Int8SteDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        qx, sx = _dynamic_quant(x)
        qw, sw = _dynamic_quant(w)
        acc = int8_mm(qx.reshape(-1, x.shape[-1]), qw)
        return (acc.float() * (sx * sw)).reshape(
            tuple(x.shape[:-1]) + (w.shape[1],))

    @staticmethod
    def backward(ctx, g):
        return _ste_grads(*ctx.saved_tensors, g)


class _Fp8SteDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        qx, sx = _dynamic_quant_fp8(x)
        qw, sw = _dynamic_quant_fp8(w)
        acc = fp8_mm(qx.reshape(-1, x.shape[-1]), qw)
        return (acc * (sx * sw)).reshape(
            tuple(x.shape[:-1]) + (w.shape[1],))

    @staticmethod
    def backward(ctx, g):
        return _ste_grads(*ctx.saved_tensors, g)


def int8_ste_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(..., d_in) x (d_in, d_out)`` with both operands quantised to
    int8 per tensor, the sums in int32, rescaled by the product of the
    two scales (f32 out). Backward: the unquantised product's
    gradients."""
    return _Int8SteDot.apply(x, w)


def fp8_ste_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`int8_ste_dot` with e4m3 operands and f32 sums."""
    return _Fp8SteDot.apply(x, w)


# ---- the int8-compressed all-reduce ----------------------------------------


def _floats(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [v for v in tree.values() if v.is_floating_point()]
    return [v for v in tree if v.is_floating_point()]


def int8_encode(leaves, ax):
    """The sending half of :func:`int8_pmean` over float ``leaves`` on
    the resolved axis ``ax``: the shared scale (local amaxes maxed, then
    ``pmax``-ed over the axis) and each leaf quantised with ``127 // n``
    headroom. Returns ``(int8 leaves, scale)``."""
    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )

    headroom = max(1, 127 // ax.size)
    amax = torch.stack([t.abs().amax().float() for t in leaves]).amax()
    amax = cc.pmax(amax, ax)
    scale = torch.where(amax > 0, amax / headroom, torch.ones_like(amax))
    return [torch.clamp(torch.round(t.float() / scale), -headroom,
                        headroom).to(torch.int8) for t in leaves], scale


def int8_decode(summed: torch.Tensor, scale: torch.Tensor, n: int,
                dtype) -> torch.Tensor:
    """The receiving half: the int8 sum back to the mean at ``dtype``."""
    return (summed.float() * (scale / n)).to(dtype)


def int8_pmean(tree, axis, *, mesh=None):
    """``pmean(tree, axis)`` with the payload on the wire in int8: a
    tensor, or a dict / list of them. One shared scale a call (the
    bucket), one int8 ``psum`` for every float leaf; non-float leaves
    pass through. The error an element is at most ``scale / 2`` with
    ``scale = amax / (127 // n)``."""
    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        resolve_axis,
    )

    ax = resolve_axis(axis, mesh)
    leaves = _floats(tree)
    if not leaves:
        return tree
    qs, scale = int8_encode(leaves, ax)
    summed = iter(cc.psum(qs, ax))
    done = {id(t): int8_decode(next(summed), scale, ax.size, t.dtype)
            for t in leaves}
    if isinstance(tree, torch.Tensor):
        return done[id(tree)]
    if isinstance(tree, Mapping):
        return {k: done.get(id(v), v) for k, v in tree.items()}
    return [done.get(id(v), v) for v in tree]


def lint_contracts():
    """Contract for the fp8 straight-through training product, the
    program that exercises the precision rule's fp8 gate: e4m3fn factors
    only (``torch._scaled_mm`` on the card, e4m3 values widened to f32 by
    the CPU's plain version), f32 sums, an f32 dequant scale on the
    result, and straight-through f32 gradients (no fp8 product in the
    backward: its products run on the unquantised operands, which the
    f32-factor check covers)."""
    import numpy as np

    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        ProgramContract,
    )

    N, D_IN, D_OUT = 8, 16, 32

    def _build(device):
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.standard_normal((N, D_IN)).astype(
            np.float32)).to(device).requires_grad_()
        w = torch.from_numpy((rng.standard_normal((D_IN, D_OUT)) * 0.1)
                             .astype(np.float32)).to(device).requires_grad_()

        def loss_and_grad(x, w):
            loss = (fp8_ste_dot(x, w) ** 2).sum()
            return (loss, *torch.autograd.grad(loss, (x, w)))

        return loss_and_grad, (x, w)

    return [
        ProgramContract(
            name="fp8_ste_matmul_grad",
            build=_build,
            policy="fp8",
            collectives={},  # single shard: the quantiser is device-local
            fp8_matmuls=True,
            sources=("distributed_tensorflow_guide_tpu_torch.ops.quant",),
            notes="e4m3 factors, f32 sums, f32 dequant scales, "
                  "straight-through backward"),
    ]
