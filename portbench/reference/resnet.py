"""ResNet-50 in plain PyTorch, float32: the reference of the ResNet cell.
It imports nothing of the port; it takes the weights the benchmark drew
from the seed, under the names of the port's state dict.

The v1.5 bottleneck ResNet (He et al., arXiv:1512.03385, table 1, with
the stride on the 3x3 convolution), as the port runs it
(``models/resnet.ResNet50``), whose conventions are flax's:

* SAME padding as ``lax.padtype_to_pads``: total max((out - 1) stride + k
  - size, 0), the odd pixel at the end; the 7x7 stem pads (3, 3); the
  3x3 stride-2 max-pool pads with -inf the same way;
* BatchNorm in train mode: batch statistics over (N, H, W), the biased
  variance E[x^2] - E[x]^2 clamped at 0, eps 1e-5;
* bias-free convolutions, a global mean pool and a dense head with bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import operand

BN_EPS = 1e-5


def same_pads(size: int, k: int, stride: int) -> tuple:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1, pads=None, fp8=False):
    k = w.shape[-1]
    ph = pads or same_pads(x.shape[2], k, stride)
    pw = pads or same_pads(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(operand(x, fp8), operand(w, fp8), stride=stride)


def batch_norm(x, w, b):
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
        + b[None, :, None, None]


def forward(w: dict, image: torch.Tensor, *, stage_sizes,
            fp8: bool = False) -> torch.Tensor:
    """(B, H, W, 3) f32 image -> (B, classes) f32 logits."""
    x = image.permute(0, 3, 1, 2)
    x = conv(x, w["conv_init.weight"], 2, pads=(3, 3), fp8=fp8)
    x = F.relu(batch_norm(x, w["bn_init.weight"], w["bn_init.bias"]))
    ph, pw = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                           value=float("-inf")), 3, 2)
    i = 0
    for stage, count in enumerate(stage_sizes):
        for j in range(count):
            p = f"blocks.{i}."
            stride = 2 if stage > 0 and j == 0 else 1
            y = F.relu(batch_norm(conv(x, w[p + "conv0.weight"], fp8=fp8),
                                  w[p + "bn0.weight"], w[p + "bn0.bias"]))
            y = F.relu(batch_norm(
                conv(y, w[p + "conv1.weight"], stride, fp8=fp8),
                w[p + "bn1.weight"], w[p + "bn1.bias"]))
            y = batch_norm(conv(y, w[p + "conv2.weight"], fp8=fp8),
                           w[p + "bn2.weight"], w[p + "bn2.bias"])
            if p + "conv_proj.weight" in w:
                x = batch_norm(
                    conv(x, w[p + "conv_proj.weight"], stride, fp8=fp8),
                    w[p + "norm_proj.weight"], w[p + "norm_proj.bias"])
            x = F.relu(x + y)
            i += 1
    feats = x.mean((2, 3))
    return operand(feats, fp8) @ operand(w["head.weight"], fp8).t() \
        + w["head.bias"]


def loss(w: dict, image, label, **kw) -> torch.Tensor:
    """The mean softmax cross-entropy of the logits against the labels."""
    logp = torch.log_softmax(forward(w, image, **kw), dim=-1)
    return -logp.gather(1, label.long()[:, None]).mean()
