"""ResNet: judged config 2 ("ResNet-50 ImageNet MultiWorkerMirroredStrategy,
NCCL allreduce"), the north-star throughput model.

The JAX package's ``models/resnet.py`` in PyTorch: the v1.5 bottleneck
(stride on the 3x3 conv), BatchNorm whose running statistics the data-
parallel step averages over the replicas
(``DataParallel.make_train_step_with_stats``), an optional folded
BatchNorm + ReLU (``FusedBatchNormAct``) and per-block activation
checkpointing (``remat``).

Layout and precision. Images arrive NHWC, as the JAX model takes them;
``permute(0, 3, 1, 2)`` views them as NCHW with ``channels_last`` strides
at no copy, and the convolution weights are ``channels_last`` too, so
every convolution runs in that layout. Parameters are f32; convolutions
and BatchNorm outputs are at ``dtype`` (bf16 on the card), the
statistics in f32, the head in f32.

Three rules of flax that torch's stock layers do not follow, each kept
here:

* ``SAME`` padding is ``lax.padtype_to_pads``: total ``max((out - 1) *
  stride + k - size, 0)`` with the odd pixel at the end, so the stride-2
  3x3 conv and the stem's 3x3 stride-2 max-pool pad (0, 1) at even sizes
  (``nn.Conv2d(padding=1)`` and ``MaxPool2d(3, 2, 1)`` pad (1, 1): the
  same output size from other windows). The 1x1 stride-2 projection pads
  (0, 0); the 7x7 stem pads (3, 3) explicitly.
* BatchNorm's batch variance is E[x^2] - E[x]^2 in f32, clamped at 0:
  biased, and the running variance takes that biased value
  (``ra = 0.9 ra + 0.1 batch``). ``nn.BatchNorm2d`` would store the
  unbiased one. :class:`BatchNorm` is the flax algebra, with the state
  dict keys ``weight``, ``bias``, ``running_mean``, ``running_var``.
* The running statistics are updated once per forward, also under
  ``remat``: the recomputation in the backward does not update them again.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_guide_tpu_torch.models.initializers import (
    generator_for,
    lecun_normal,
)
from distributed_tensorflow_guide_tpu_torch.models.losses import (
    accuracy,
    cross_entropy_loss,
)


BN_MOMENTUM, BN_EPS = 0.9, 1e-5  # flax's, as the JAX model sets them


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax's ``SAME`` padding of one spatial axis (``lax.padtype_to_pads``):
    (low, high), the odd pixel at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _padded(op, x, ph, pw, value=0.0, **kw):
    """``op(x, padding=...)`` with (low, high) pads per axis: torch's own
    padding where they are symmetric, an explicit ``F.pad`` (filled with
    ``value``) where they are not."""
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return op(x, padding=(ph[0], pw[0]), **kw)
    return op(F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value),
              padding=0, **kw)


class Conv(nn.Module):
    """A bias-free convolution at ``dtype`` with flax's padding: ``"SAME"``
    or explicit ((top, bottom), (left, right)). Weight (out, in, kh, kw)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 padding="SAME", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.padding, self.dtype = (k, stride, padding,
                                                          dtype)

    def forward(self, x):
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], self.k, self.stride)
            pw = same_pads(x.shape[3], self.k, self.stride)
        else:
            ph, pw = self.padding
        return _padded(F.conv2d, x.to(self.dtype),
                       ph, pw, weight=self.weight.to(self.dtype),
                       stride=self.stride)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) over NCHW, with an
    optional ReLU after it.

    Train mode: f32 batch statistics, the variance E[x^2] - E[x]^2 clamped
    at 0; ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32,
    cast to ``dtype``; the running statistics move by ``ra = 0.9 ra + 0.1
    batch`` unless ``update`` is False. Eval mode normalises with the
    running statistics and writes nothing.
    """

    def __init__(self, features: int, *, dtype: torch.dtype = torch.bfloat16,
                 act: bool = False, scale_init: float = 1.0):
        super().__init__()
        self.dtype, self.act, self.scale_init = dtype, act, scale_init
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(self.scale_init)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _stats(self, x, update: bool):
        if not self.training:
            return self.running_mean, self.running_var
        x32 = x.float()
        dims = (0, 2, 3)
        mean = x32.mean(dims)
        var = torch.clamp(torch.mean(x32 * x32, dims) - mean * mean,
                          min=0.0)
        if update:
            m = BN_MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return mean, var

    def _normalize(self, x, mean, var):
        def c(t):  # per channel, broadcast over (N, C, H, W)
            return t[None, :, None, None]

        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - c(mean)) * c(mul) + c(self.bias)).to(self.dtype)

    def forward(self, x, update: bool = True):
        y = self._normalize(x, *self._stats(x, update))
        return F.relu(y) if self.act else y


class FusedBatchNormAct(BatchNorm):
    """BatchNorm (+ ReLU) as one folded pass, the JAX package's
    ``FusedBatchNormAct``: the same f32 statistics of the (bf16) input,
    then ``k = weight * rsqrt(var + eps)`` and ``b = bias - mean * weight *
    rsqrt(var + eps)`` at ``dtype``, and ``y = x * k + b`` at ``dtype``.
    Same parameters, buffers and state dict keys as :class:`BatchNorm`."""

    def _normalize(self, x, mean, var):
        rstd = torch.rsqrt(var + BN_EPS)
        k = (self.weight * rstd).to(self.dtype)
        b = (self.bias - mean * self.weight * rstd).to(self.dtype)
        return x.to(self.dtype) * k[None, :, None, None] + b[None, :, None,
                                                              None]


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x filters), each followed by BatchNorm,
    ReLU after the first two and after the residual sum; a strided 1x1
    projection with its BatchNorm where the shapes differ. The last
    BatchNorm's scale starts at zero."""

    def __init__(self, cin: int, filters: int, stride: int = 1, *,
                 dtype: torch.dtype = torch.bfloat16, fused_bn: bool = False):
        super().__init__()
        norm = functools.partial(FusedBatchNormAct if fused_bn else BatchNorm,
                                 dtype=dtype)
        conv = functools.partial(Conv, dtype=dtype)
        cout = 4 * filters
        self.conv0 = conv(cin, filters, 1)
        self.bn0 = norm(filters, act=True)
        self.conv1 = conv(filters, filters, 3, stride)
        self.bn1 = norm(filters, act=True)
        self.conv2 = conv(filters, cout, 1)
        self.bn2 = norm(cout, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if cin != cout or stride != 1:
            self.conv_proj = conv(cin, cout, 1, stride)
            self.norm_proj = norm(cout)

    def forward(self, x, update_stats: bool = True):
        y = self.bn0(self.conv0(x), update_stats)
        y = self.bn1(self.conv1(y), update_stats)
        y = self.bn2(self.conv2(y), update_stats)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), update_stats)
        return F.relu(residual + y)


def _checkpointed(block: BottleneckBlock, x):
    """``block(x)`` whose activations are recomputed in the backward; the
    first call (the forward) updates the running statistics, the
    recomputation does not."""
    first = [True]

    def run(inp):
        update, first[0] = first[0], False
        return block(inp, update_stats=update)

    return checkpoint(run, x, use_reentrant=False)


class ResNet(nn.Module):
    """``forward(image)``: (B, H, W, C) NHWC -> (B, num_classes) f32 logits.

    ``small_inputs`` replaces the 7x7 stride-2 stem and its max-pool with a
    3x3 stride-1 conv (images of 64 pixels or fewer). ``remat`` recomputes
    each bottleneck block in the backward (same numerics). ``fused_bn``
    takes :class:`FusedBatchNormAct` for every BatchNorm (same state
    dict). Train or eval mode is the module's (``model.train()`` /
    ``model.eval()``): batch or running statistics.
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 small_inputs: bool = False, remat: bool = False,
                 fused_bn: bool = False):
        super().__init__()
        self.dtype, self.small_inputs, self.remat = dtype, small_inputs, remat
        norm = FusedBatchNormAct if fused_bn else BatchNorm
        if small_inputs:
            self.conv_init = Conv(3, num_filters, 3, dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2,
                                  padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = norm(num_filters, dtype=dtype, act=True)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(BottleneckBlock(
                    cin, filters, 2 if i > 0 and j == 0 else 1, dtype=dtype,
                    fused_bn=fused_bn))
                cin = 4 * filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ResNet":
        """flax's defaults, drawn on the parameters' device: lecun-normal
        conv and head kernels, a zero head bias, BatchNorm at (1, 0) and
        the last BatchNorm of each block at scale 0."""
        gen = generator_for(self, seed)
        for mod in self.modules():
            if isinstance(mod, (Conv, nn.Linear)):
                w = mod.weight
                w.copy_(lecun_normal(w.shape, w[0].numel(), gen))
            if isinstance(mod, BatchNorm):
                mod.reset_parameters()
        self.head.bias.zero_()
        return self

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = self.bn_init(self.conv_init(image.permute(0, 3, 1, 2)))
        if not self.small_inputs:
            ph = same_pads(x.shape[2], 3, 2)
            pw = same_pads(x.shape[3], 3, 2)
            x = _padded(F.max_pool2d, x, ph, pw, value=float("-inf"),
                        kernel_size=3, stride=2)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = _checkpointed(block, x) if remat else block(x)
        return F.linear(x.mean((2, 3)).float(), self.head.weight,
                        self.head.bias)


ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet18ish = functools.partial(ResNet, stage_sizes=(1, 1, 1, 1))


def make_loss_fn(model: ResNet, weight_decay: float = 0.0):
    """``loss_fn(module, batch) -> (loss, {"accuracy"})`` for
    ``DataParallel.make_train_step_with_stats``. ``weight_decay`` adds
    ``0.5 * wd * sum(p ** 2)`` over the parameters with ``ndim > 1`` (conv
    and dense kernels, never BatchNorm)."""

    def loss_fn(module, batch):
        logits = module(batch["image"])
        loss = cross_entropy_loss(logits, batch["label"])
        if weight_decay:
            loss = loss + 0.5 * weight_decay * sum(
                torch.sum(p.float() ** 2) for p in module.parameters()
                if p.ndim > 1)
        return loss, {"accuracy": accuracy(logits, batch["label"])}

    return loss_fn


def make_metric_fn(model: ResNet):
    """``metric_fn(module, batch) -> {"loss", "accuracy"}`` for
    ``DataParallel.make_eval_step_with_stats``, which runs the module in
    eval mode (running statistics, nothing written)."""

    def metric_fn(module, batch):
        logits = module(batch["image"])
        return {"loss": cross_entropy_loss(logits, batch["label"]),
                "accuracy": accuracy(logits, batch["label"])}

    return metric_fn
