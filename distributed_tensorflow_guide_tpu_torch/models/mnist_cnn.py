"""The MNIST CNN: judged config 1 ("MNIST CNN under
tf.distribute.MirroredStrategy, single host").

Conv(32) -> ReLU -> avg-pool -> Conv(64) -> ReLU -> avg-pool -> Dense(128)
-> ReLU -> Dense(10), as the JAX package's ``models/mnist_cnn.py``.
Images arrive NHWC, (B, 28, 28, 1); the model views them as NCHW
(``permute``, no copy) for the convolutions, and flattens in NHWC order
before ``Dense(128)``, as flax does, so that the bridge's Dense kernel is
a plain transpose. Everything is f32, the judged config's precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_guide_tpu_torch.models.initializers import (
    generator_for,
    lecun_normal,
)
from distributed_tensorflow_guide_tpu_torch.models.losses import (
    accuracy,
    cross_entropy_loss,
)


class MNISTCNN(nn.Module):
    """Conv(32) -> Conv(64) -> Dense(128) -> Dense(10), ReLU + avg-pool."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        # flax's "SAME" padding of a stride-1 3x3 conv is (1, 1)
        self.conv0 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv1 = nn.Conv2d(32, 64, 3, padding=1)
        self.dense0 = nn.Linear(7 * 7 * 64, 128)
        self.dense1 = nn.Linear(128, num_classes)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "MNISTCNN":
        """flax's defaults: lecun-normal kernels, zero biases; drawn on the
        parameters' device."""
        gen = generator_for(self, seed)
        for mod in (self.conv0, self.conv1, self.dense0, self.dense1):
            w = mod.weight
            w.copy_(lecun_normal(w.shape, w[0].numel(), gen))
            mod.bias.zero_()
        return self

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 28, 28, 1) NHWC -> (B, num_classes) f32 logits."""
        x = image.float().permute(0, 3, 1, 2)
        for conv in (self.conv0, self.conv1):
            x = F.avg_pool2d(F.relu(conv(x)), 2)
        # NHWC order, as flax's reshape of its NHWC activations
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense1(F.relu(self.dense0(x)))


def make_loss_fn(model: MNISTCNN):
    """``loss_fn(module, batch) -> (loss, {"accuracy"})`` for
    ``DataParallel.make_train_step``."""

    def loss_fn(module, batch):
        logits = module(batch["image"])
        loss = cross_entropy_loss(logits, batch["label"])
        return loss, {"accuracy": accuracy(logits, batch["label"])}

    return loss_fn


def make_metric_fn(model: MNISTCNN):
    """``metric_fn(module, batch) -> {"loss", "accuracy"}`` for
    ``DataParallel.make_eval_step``: the same forward, no gradient."""

    def metric_fn(module, batch):
        logits = module(batch["image"])
        return {"loss": cross_entropy_loss(logits, batch["label"]),
                "accuracy": accuracy(logits, batch["label"])}

    return metric_fn
