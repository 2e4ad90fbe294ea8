"""Deterministic synthetic datasets: the offline stand-in for MNIST,
ImageNet and click-through logs.

A copy of the JAX package's ``data/synthetic.py`` (numpy only, the same
``RandomState`` draws in the same order), so that one seed gives the two
packages bitwise-equal batches. Each class gets a fixed random prototype
and a sample is its prototype plus Gaussian noise: the task is learnable
and fully determined by the seed.

Batches are host numpy arrays; images are NHWC, as the JAX package's
models take them (``models/resnet.py`` views them as NCHW in
``channels_last`` without a copy).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticClassification:
    """Infinite iterator of {image, label} batches."""

    def __init__(
        self,
        batch_size: int,
        *,
        image_shape: tuple[int, ...] = (28, 28, 1),
        num_classes: int = 10,
        noise: float = 0.3,
        seed: int = 0,
        sample_seed: int | None = None,
        dtype=np.float32,
    ):
        """``seed`` fixes the class prototypes (the *task*); ``sample_seed``
        fixes the label/noise draws (the *samples*, default ``seed + 1``).
        A held-out stream for the same task = same seed, different
        sample_seed — the synthetic analogue of a train/test split."""
        self.batch_size = batch_size
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.noise = noise
        self.dtype = dtype
        proto_rng = np.random.RandomState(seed)
        self.prototypes = proto_rng.randn(num_classes, *image_shape).astype(dtype)
        self._rng = np.random.RandomState(
            seed + 1 if sample_seed is None else sample_seed)

    def __iter__(self) -> Iterator[dict]:
        while True:
            labels = self._rng.randint(0, self.num_classes, self.batch_size)
            images = self.prototypes[labels] + self.noise * self._rng.randn(
                self.batch_size, *self.image_shape
            ).astype(self.dtype)
            yield {"image": images.astype(self.dtype), "label": labels.astype(np.int32)}

    def take(self, n: int) -> list[dict]:
        it = iter(self)
        return [next(it) for _ in range(n)]


def synthetic_mnist(batch_size: int, seed: int = 0,
                    sample_seed: int | None = None) -> SyntheticClassification:
    return SyntheticClassification(batch_size, seed=seed,
                                   sample_seed=sample_seed)


class SyntheticCTR:
    """Click-through batches for the Wide&Deep config: categorical ids +
    dense features, labels from a fixed logistic ground truth (learnable,
    deterministic)."""

    def __init__(
        self,
        batch_size: int,
        *,
        vocab_sizes=(1000, 1000, 100, 100, 10),
        num_dense: int = 8,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.vocab_sizes = tuple(vocab_sizes)
        self.num_dense = num_dense
        gt = np.random.RandomState(seed)
        # ground-truth per-id weights + dense weights defining p(click)
        self._id_w = [gt.randn(v).astype(np.float32) * 0.5 for v in self.vocab_sizes]
        self._dense_w = gt.randn(num_dense).astype(np.float32) * 0.5
        self._rng = np.random.RandomState(seed + 1)

    def __iter__(self):
        while True:
            cat = np.stack(
                [
                    self._rng.randint(0, v, self.batch_size)
                    for v in self.vocab_sizes
                ],
                axis=1,
            ).astype(np.int32)
            dense = self._rng.randn(self.batch_size, self.num_dense).astype(
                np.float32
            )
            logit = dense @ self._dense_w + sum(
                self._id_w[i][cat[:, i]] for i in range(len(self.vocab_sizes))
            )
            p = 1.0 / (1.0 + np.exp(-logit))
            label = (self._rng.rand(self.batch_size) < p).astype(np.int32)
            yield {"cat": cat, "dense": dense, "label": label}

    def take(self, n: int) -> list[dict]:
        it = iter(self)
        return [next(it) for _ in range(n)]


def synthetic_imagenet(
    batch_size: int, image_size: int = 224, seed: int = 0
) -> SyntheticClassification:
    return SyntheticClassification(
        batch_size,
        image_shape=(image_size, image_size, 3),
        num_classes=1000,
        seed=seed,
    )
