"""Wide&Deep: judged config 4 ("Wide&Deep recommender, async PS ->
synchronous allreduce").

The JAX package's ``models/wide_deep.py``: a wide linear path over the
categorical fields (one scalar weight per id, plus a dense projection of
the dense features) and a deep path (one embedding per field,
concatenated with the dense features, through an MLP), summed into one
logit. The embedding tables are dense ``nn.Embedding`` tables on the
card, and their gradients are dense too, averaged like every other
gradient by the data-parallel step: the card's memory is the parameter
server. Everything is f32, the judged config's precision.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_guide_tpu_torch.models.initializers import (
    generator_for,
    lecun_normal,
)


class WideDeep(nn.Module):
    """``forward(cat, dense)``: (B, n_fields) int ids and (B, num_dense)
    float features -> (B,) f32 logits."""

    def __init__(self, vocab_sizes: Sequence[int], num_dense: int = 8,
                 embed_dim: int = 16, mlp_dims: Sequence[int] = (128, 64)):
        super().__init__()
        self.wide = nn.ModuleList(nn.Embedding(v, 1) for v in vocab_sizes)
        self.wide_dense = nn.Linear(num_dense, 1)
        self.emb = nn.ModuleList(nn.Embedding(v, embed_dim)
                                 for v in vocab_sizes)
        dims = [len(vocab_sizes) * embed_dim + num_dense, *mlp_dims]
        self.mlp = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(dims, dims[1:]))
        self.deep_out = nn.Linear(dims[-1], 1)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "WideDeep":
        """flax's defaults, on the parameters' device: embeddings normal
        with variance 1 / width, Dense kernels lecun-normal, zero
        biases."""
        gen = generator_for(self, seed)
        for emb in (*self.wide, *self.emb):
            w = emb.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                    / w.shape[1] ** 0.5)
        for lin in (self.wide_dense, *self.mlp, self.deep_out):
            lin.weight.copy_(lecun_normal(lin.weight.shape,
                                          lin.weight.shape[1], gen))
            lin.bias.zero_()
        return self

    def forward(self, cat: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        cat, dense = cat.long(), dense.float()
        wide = torch.zeros(cat.shape[0], device=cat.device)
        for i, table in enumerate(self.wide):
            wide = wide + table(cat[:, i])[:, 0]
        wide = wide + self.wide_dense(dense)[:, 0]
        x = torch.cat([table(cat[:, i]) for i, table in enumerate(self.emb)]
                      + [dense], dim=-1)
        for lin in self.mlp:
            x = F.relu(lin(x))
        return wide + self.deep_out(x)[:, 0]


def make_loss_fn(model: WideDeep):
    """``loss_fn(module, batch) -> (loss, {"accuracy"})``: binary
    cross-entropy on the click label in its stable form
    ``max(l, 0) - l * y + log1p(exp(-|l|))``, and the share of logits on
    the label's side of 0."""

    def loss_fn(module, batch):
        logit = module(batch["cat"], batch["dense"])
        label = batch["label"].float()
        loss = torch.mean(torch.clamp(logit, min=0) - logit * label
                          + torch.log1p(torch.exp(-logit.abs())))
        acc = ((logit > 0) == (label > 0.5)).float().mean()
        return loss, {"accuracy": acc}

    return loss_fn
