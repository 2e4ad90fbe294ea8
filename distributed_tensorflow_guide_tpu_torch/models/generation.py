"""Autoregressive generation: the one-shot KV-cache generator and the
samplers the serve engine shares with it.

* The prompt goes through the model in one chunk (the contiguous decode
  view, ``models/transformer.py``), which fills the cache; each later
  token is one more chunk of width 1. The JAX package's ``lax.scan`` is a
  Python loop here; the cache is updated in place.
* Sampling: greedy (``temperature == 0``, an exact argmax), temperature,
  and top-k. A sampled token is a pure function of (request key,
  absolute position, logits): the Gumbel noise comes from a counter-based
  hash of the request's (2,) uint32 key, the position of the token being
  drawn, and the vocabulary index. That is what lets the serve engine,
  which interleaves requests in any order and batch width, emit each
  request's stream bitwise as this generator does for the request alone.
  The bits differ from JAX's threefry draws, so sampled streams are not
  comparable with the JAX package's; greedy streams are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def decode_config(cfg: TransformerConfig) -> TransformerConfig:
    """The serving view of a training config: KV-cache attention."""
    return dataclasses.replace(cfg, decode=True)


def init_cache(model: Transformer, batch_size: int) -> list[dict]:
    """Zeroed contiguous cache for ``batch_size`` sequences (the model must
    be a decode view, see :func:`decode_config`)."""
    return model.init_cache(batch_size)


# --------------------------------------------------------------------------
# counter-based sampling noise
# --------------------------------------------------------------------------


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values below
    2**32 (every product stays below 2**63)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    return (x >> 16) ^ x


def position_seeds(keys, positions) -> torch.Tensor:
    """(B, 2) request keys and (B,) absolute positions -> (B,) int64
    seeds: the counterpart of JAX's ``fold_in(rng, position)``."""
    keys = torch.as_tensor(keys).to(torch.int64) & _MASK32
    positions = torch.as_tensor(positions).to(torch.int64) & _MASK32
    h = _mix32(_mix32(keys[..., 0]) ^ keys[..., 1])
    return _mix32(h ^ positions)


def _gumbel(seeds, rows, vocab: int) -> torch.Tensor:
    """(B, V) float32 Gumbel noise; row b draws counters
    ``rows[b] * V + v`` from seed ``seeds[b]``."""
    v = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    ctr = rows[:, None] * vocab + v[None, :]
    x = _mix32((seeds[:, None] + ctr * _GOLDEN) & _MASK32)
    u = ((x >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))  # (0, 1)
    return -torch.log(-torch.log(u))


def _pick(logits, seeds, rows, temperature: float, top_k: int | None):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    g = _gumbel(seeds, rows, logits.shape[-1])
    return torch.argmax(logits + g, dim=-1)


def _sample(logits, seed, temperature: float, top_k: int | None):
    """(B, V) logits -> (B,) int64 tokens; one seed for the whole call
    (row b takes counters from row offset b)."""
    B = logits.shape[0]
    seed = torch.as_tensor(seed, device=logits.device).reshape(1)
    rows = torch.arange(B, device=logits.device)
    return _pick(logits, seed.expand(B), rows, temperature, top_k)


def sample_rows(logits, seeds, temperature: float, top_k: int | None):
    """Per-row sampling: row b with its own seed is bitwise what a B=1
    :func:`_sample` call with that seed emits — the engine's sampler."""
    rows = torch.zeros(logits.shape[0], dtype=torch.int64,
                       device=logits.device)
    return _pick(logits, seeds.to(logits.device), rows, temperature, top_k)


# --------------------------------------------------------------------------
# the one-shot generator
# --------------------------------------------------------------------------


def make_generate_fn(cfg: TransformerConfig, *, max_new_tokens: int,
                     temperature: float = 1.0, top_k: int | None = None,
                     device=None):
    """Build ``generate(model, prompt (B, P), rng (2,) uint32) -> (B, P +
    max_new_tokens)``: prefill the prompt in one chunk, then decode one
    token per step through the K5 kernel. ``model`` holds the weights (a
    :class:`Transformer` of ``cfg``'s widths, any view) on ``device``
    (default the first CUDA card). ``P + max_new_tokens`` must fit
    ``cfg.max_len``."""
    dcfg = decode_config(cfg)
    dev = resolve_device(device)

    @torch.inference_mode()
    def generate(model: Transformer, prompt, rng) -> torch.Tensor:
        if model.device != dev:
            raise ValueError(f"model lives on {model.device}, generator "
                             f"on {dev}")
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=dev)
        B, P = prompt.shape
        if P + max_new_tokens > dcfg.max_len:
            raise ValueError(f"prompt {P} + max_new_tokens "
                             f"{max_new_tokens} exceeds max_len "
                             f"{dcfg.max_len}")
        key = torch.as_tensor(np.asarray(rng, np.uint32).astype(np.int64),
                              device=dev)

        def seed(pos):
            return position_seeds(key, torch.tensor(pos, device=dev))

        dm = model.with_config(dcfg)
        cache = dm.init_cache(B)
        logits = dm(prompt, 0, cache=cache)
        tok = _sample(logits[:, -1], seed(P), temperature, top_k)
        new = [tok]
        for idx in range(P, P + max_new_tokens - 1):
            logits = dm(tok[:, None], idx, cache=cache)
            tok = _sample(logits[:, -1], seed(idx + 1), temperature, top_k)
            new.append(tok)
        return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)

    return generate
