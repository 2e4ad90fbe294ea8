"""The precisions a reference computes in: float32 (the reference, with
TF32 off) and, for the control, fp8 products.

fp8 products as an H100's fp8 tensor cores take them: each operand
quantised per tensor to e4m3 (its absolute maximum onto 448, the format's
largest finite value), the products summed in f32 and scaled back; the
backward passes the gradient straight through (the quantised value's
gradient is the unquantised one's). Here the quantised operands are
widened back to f32 and multiplied in f32, which sums exactly what an fp8
tensor core sums, up to the order of the f32 additions.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def float32_exact():
    """Matmuls and convolutions in full f32 (TF32 off) and cuDNN's default
    algorithms, restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    bench = torch.backends.cudnn.benchmark
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.backends.cudnn.benchmark = bench


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` quantised to e4m3 with one scale for the whole tensor, as f32;
    the gradient passes straight through."""
    with torch.no_grad():
        amax = t.detach().abs().amax().float()
        scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
        q = (t.detach() / scale).clamp(-E4M3_MAX, E4M3_MAX).to(
            torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def operand(t: torch.Tensor, fp8: bool) -> torch.Tensor:
    """A product's operand at the reference's precision."""
    return fp8_round(t) if fp8 else t
