"""Tiny shared programs the contract providers run.

Every registered program is built at toy scale, at the JAX package's
geometry: a 4-leaf MLP for the data-parallel family of contracts and a
2-layer transformer for the decode contracts. The contracts audit
*structure* (collectives, dtypes, in-place state, shapes), which does not
depend on scale; correctness at real scale stays with the subsystem
tests and the card. Weights come from a numpy seed, so a program is the
same on every device.
"""

from __future__ import annotations

import numpy as np
import torch


def _normal(rng: np.random.RandomState, shape, scale: float) -> torch.Tensor:
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def tiny_mlp(device="cpu", seed: int = 0):
    """(loss_fn, state, batch): 4 parameters (w1 (16, 32), b1 (32,),
    w2 (32, 16), b2 (16,)) under SGD with momentum, so the optimizer state
    carries float leaves. ``loss_fn(module, batch) -> (loss, metrics)``,
    the port's loss signature."""
    from distributed_tensorflow_guide_tpu_torch.train.state import (
        TrainState,
    )

    rng = np.random.RandomState(seed)

    class _MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w1 = torch.nn.Parameter(_normal(rng, (16, 32), 0.1))
            self.b1 = torch.nn.Parameter(torch.zeros(32))
            self.w2 = torch.nn.Parameter(_normal(rng, (32, 16), 0.1))
            self.b2 = torch.nn.Parameter(torch.zeros(16))

        def forward(self, x):
            return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2

    def loss_fn(module, batch):
        err = module(batch["x"]) - batch["y"]
        return (err ** 2).mean(), {"mae": err.abs().mean()}

    module = _MLP().to(device)
    state = TrainState(module, torch.optim.SGD(module.parameters(), lr=0.1,
                                               momentum=0.9))
    batch = {"x": _normal(rng, (8, 16), 1.0).to(device),
             "y": _normal(rng, (8, 16), 1.0).to(device)}
    return loss_fn, state, batch


def tiny_lm_cfg(**overrides):
    """The toy TransformerConfig the decode contracts run (f32)."""
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    kw = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=16,
              d_ff=32, max_len=8, causal=True, dtype=torch.float32)
    kw.update(overrides)
    return TransformerConfig(**kw)


def tiny_lm(cfg, device="cpu", seed: int = 0):
    """A Transformer of ``cfg`` whose weights are drawn from a numpy seed:
    normal(0.02) for every matrix and embedding, the constructor's
    values (zero biases, unit LayerNorm scales) elsewhere."""
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
    )

    rng = np.random.RandomState(seed)
    model = Transformer(cfg)
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(_normal(rng, tuple(p.shape), 0.02))
    return model.to(device)
