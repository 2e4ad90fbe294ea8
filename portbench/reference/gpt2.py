"""GPT-2 small in plain PyTorch, float32: the reference of the GPT-2
cells. It imports nothing of the port; it takes the weights the benchmark
drew from the seed, under the names of the port's state dict.

The model as the port runs it (``models/transformer.gpt2_124m``), which
departs from the published GPT-2 (Radford et al. 2019; the
``config.json`` of huggingface.co/openai-community/gpt2) in four ways,
kept here so the two compute the same function:

* LayerNorm: statistics in f32, the variance E[x^2] - E[x]^2 clamped at
  0, eps 1e-6 (flax's default; GPT-2's is 1e-5);
* no bias on the QKV and output projections, nor on the MLP's down
  projection (the MLP's up projection keeps its bias);
* the LM head is its own matrix, not tied to the token embedding;
* the vocabulary is padded to 50304 rows (nanoGPT's padding); the padded
  rows take part in the softmax.

Pre-LN blocks, learned positions, tanh GELU, causal softmax attention:
as published.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.precision import operand

LN_EPS = 1e-6


def layer_norm(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * w + b


def linear(x, w, b=None, fp8=False):
    y = operand(x, fp8) @ operand(w, fp8).t()
    return y if b is None else y + b


def forward(w: dict, tokens: torch.Tensor, *, layers: int, heads: int,
            fp8: bool = False) -> torch.Tensor:
    """(B, S) tokens -> (B, S, V) f32 logits. ``fp8``: every projection's
    operands in fp8 (the control)."""
    B, S = tokens.shape
    x = w["tok_emb.weight"][tokens] + w["pos_emb.weight"][:S][None]
    d = x.shape[-1]
    hd = d // heads
    mask = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    for i in range(layers):
        p = f"blocks.{i}."
        h = layer_norm(x, w[p + "ln1.weight"], w[p + "ln1.bias"])
        qkv = linear(h, w[p + "attn.qkv.weight"], fp8=fp8)
        q, k, v = qkv.view(B, S, 3, heads, hd).permute(2, 0, 3, 1, 4)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~mask, float("-inf"))
        att = torch.softmax(scores, dim=-1) @ v  # (B, H, S, hd)
        att = att.transpose(1, 2).reshape(B, S, d)
        x = x + linear(att, w[p + "attn.proj.weight"], fp8=fp8)
        h = layer_norm(x, w[p + "ln2.weight"], w[p + "ln2.bias"])
        h = F.gelu(linear(h, w[p + "mlp.up.weight"], w[p + "mlp.up.bias"],
                          fp8=fp8), approximate="tanh")
        x = x + linear(h, w[p + "mlp.down.weight"], fp8=fp8)
    x = layer_norm(x, w["ln_f.weight"], w["ln_f.bias"])
    return linear(x, w["lm_head.weight"], fp8=fp8)


def lm_loss(w: dict, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """The mean next-token cross-entropy over the B (S - 1) targets."""
    logits = forward(w, tokens, **kw)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long()).mean()
