"""Softmax classification: the loss and the metric that the MNIST CNN,
ResNet and the BERT classifier share."""

from __future__ import annotations

import torch


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """The mean softmax cross-entropy of (B, classes) logits against (B,)
    integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy, a 0-d f32 tensor."""
    return (logits.argmax(-1) == labels).float().mean()
