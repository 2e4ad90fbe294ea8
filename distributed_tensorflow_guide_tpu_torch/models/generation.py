"""Autoregressive generation: the one-shot KV-cache generator and the
samplers the serve engine shares with it.

* The prompt goes through the model in one chunk (the contiguous decode
  view, ``models/transformer.py``), which fills the cache; each later
  token is one more chunk of width 1. The JAX package's ``lax.scan`` is a
  Python loop here; the cache is updated in place.
* Sampling: greedy (``temperature == 0``, an exact argmax), temperature,
  and top-k, drawn as the JAX package draws them: the token at absolute
  position p of a request takes the key ``fold_in(rng, p)`` and the
  Gumbel-max draw of ``jax.random.categorical``, through this module's
  own copy of JAX's threefry-2x32 generator (partitionable random bits,
  ``uniform``, ``gumbel``) in int64 operations: on the host (numpy) for
  the position keys and for the bits of top-k's surviving columns, which
  costs no kernel launches, and on the device (torch) for a draw over
  the whole vocabulary and for the noise's floats. A sampled token is then
  a pure function of (request key, position, logits): the serve engine,
  which interleaves requests in any order and batch width, emits each
  request's stream bitwise as this generator does for the request
  alone, and the streams are the JAX package's token for token wherever
  the logits agree.
"""

from __future__ import annotations

import dataclasses
import math

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
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY32 = float(np.finfo(np.float32).tiny)


def decode_config(cfg: TransformerConfig) -> TransformerConfig:
    """The serving view of a training config: KV-cache attention."""
    return dataclasses.replace(cfg, decode=True)


def init_cache(model: Transformer, batch_size: int) -> list[dict]:
    """Zeroed contiguous cache for ``batch_size`` sequences (the model must
    be a decode view, see :func:`decode_config`)."""
    return model.init_cache(batch_size)


# --------------------------------------------------------------------------
# threefry-2x32 keys and draws (JAX's, in torch integer ops)
# --------------------------------------------------------------------------


def _u32(x, like=None):
    """uint32 values held in int64 (torch has few uint32 kernels); every
    sum of two stays below 2**33 and every shift below 2**63. A torch
    tensor on ``like``'s device where ``like`` (default ``x``) is one,
    else a numpy array: the key and count words a caller has on the host
    stay there, where a few hundred integer operations on a handful of
    values cost no launches."""
    like = x if like is None else like
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x, device=like.device).to(torch.int64) \
            & _MASK32
    return np.asarray(x, dtype=np.int64) & _MASK32


def threefry_2x32(k0, k1, x0, x1):
    """The threefry-2x32 block cipher (20 rounds), as JAX's
    ``threefry2x32_p`` computes it: key words ``k0``, ``k1`` and count words
    ``x0``, ``x1`` (uint32 values, broadcast together) -> two words, torch
    tensors where ``k0`` is one, else numpy arrays."""
    k0, k1, x0, x1 = (_u32(a, k0) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def fold_in(keys, data):
    """``jax.random.fold_in`` for raw (..., 2) uint32 keys and (...)
    integers below 2**32: the key hashed with the count (0, data).
    Returns (..., 2) int64 holding uint32 values: a torch tensor for a
    tensor of keys, a numpy array for host keys."""
    keys = _u32(keys)
    y0, y1 = threefry_2x32(keys[..., 0], keys[..., 1], 0, _u32(data, keys))
    stack = torch.stack if isinstance(keys, torch.Tensor) else np.stack
    return stack([y0, y1], -1)


def _bits_at(keys, n):
    """The partitionable random bits of raw (..., 2) ``keys`` at flat
    indices ``n`` (int64, broadcast against the keys' batch): the xor of
    the two words of threefry(key, (n >> 32, n & 0xFFFFFFFF)); torch or
    numpy as the keys are."""
    keys = _u32(keys)
    y0, y1 = threefry_2x32(keys[..., 0], keys[..., 1], n >> 32, n & _MASK32)
    return y0 ^ y1


def random_bits(keys, shape) -> torch.Tensor:
    """JAX's partitionable 32-bit random bits: for each raw (..., 2) key,
    an array of ``shape`` whose element at flat index n is
    :func:`_bits_at` n. Returns (..., *shape) int64 holding uint32
    values."""
    keys = _u32(keys)
    n = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=keys.device)
    return _bits_at(keys[..., None, :], n).reshape(*keys.shape[:-1], *shape)


def _uniform_of_bits(bits, minval: float, maxval: float) -> torch.Tensor:
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(keys, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), less 1, scaled into [minval, maxval)."""
    return _uniform_of_bits(random_bits(keys, shape), minval, maxval)


def _gumbel_of_bits(bits) -> torch.Tensor:
    return -torch.log(-torch.log(_uniform_of_bits(bits, _TINY32, 1.0)))


def gumbel(keys, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (its default "low" mode):
    -log(-log(u)) with u uniform in [tiny, 1)."""
    return _gumbel_of_bits(random_bits(keys, shape))


def _tempered(logits, temperature: float, top_k: int | None):
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def _host(keys) -> np.ndarray:
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    return np.asarray(keys, dtype=np.int64)


def _gumbel_max_live(logits, keys, row_stride: int) -> torch.Tensor:
    """argmax over each row of (B, V) ``logits`` plus Gumbel noise, the
    noise of row b at column v being the draw of key ``keys[b]`` (host,
    (B, 2)) at flat index b * row_stride + v, computed only where the
    logit is above -inf: a column at -inf cannot win against a finite
    one. The same token as the argmax over the whole row (first index
    among equals), bit for bit, at the cost of the live columns alone
    (top-k's k, or its ties). Finding them (``nonzero``) waits for the
    logits; their random bits are then integer work on the host (no
    launches), and the floats of the noise are the device's, as in
    :func:`gumbel`."""
    B, V = logits.shape
    rows, cols = (logits > float("-inf")).nonzero(as_tuple=True)
    r, c = rows.cpu().numpy(), cols.cpu().numpy()
    bits = torch.as_tensor(_bits_at(keys[r], r * row_stride + c),
                           device=logits.device)
    val = _gumbel_of_bits(bits) + logits[rows, cols]
    best = logits.new_full((B,), float("-inf")).scatter_reduce(
        0, rows, val, "amax")
    first = torch.where(val == best[rows], cols, V)
    return cols.new_full((B,), V).scatter_reduce(0, rows, first, "amin")


def _sample(logits, key, temperature: float, top_k: int | None):
    """(B, V) float32 logits -> (B,) int64 tokens. Greedy when
    ``temperature == 0`` (an exact argmax); else
    ``jax.random.categorical(key, logits)``: one (2,) key (host or
    tensor) for the whole call, Gumbel noise of shape (B, V) (row b draws
    counts b * V + v), drawn at the top-k columns alone when ``top_k`` is
    set."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _tempered(logits, temperature, top_k)
    B, V = logits.shape
    if top_k is not None:
        return _gumbel_max_live(
            logits, np.broadcast_to(_host(key), (B, 2)), V)
    key = torch.as_tensor(_host(key), device=logits.device)
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


def sample_rows(logits, keys, temperature: float, top_k: int | None):
    """Per-row sampling with (B, 2) keys (host or tensor): row b is
    bitwise what a B=1 :func:`_sample` call with key b emits — the
    engine's sampler."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _tempered(logits, temperature, top_k)
    if top_k is not None:
        return _gumbel_max_live(logits, _host(keys), 0)
    keys = torch.as_tensor(_host(keys), device=logits.device)
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


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
        key = np.asarray(rng, np.uint32).astype(np.int64)  # host

        def pick(logits, pos):  # greedy derives no key
            k = fold_in(key, pos) if temperature != 0.0 else None
            return _sample(logits[:, -1], k, temperature, top_k)

        dm = model.with_config(dcfg)
        cache = dm.init_cache(B)
        tok = pick(dm(prompt, 0, cache=cache), P)
        new = [tok]
        for idx in range(P, P + max_new_tokens - 1):
            tok = pick(dm(tok[:, None], idx, cache=cache), idx + 1)
            new.append(tok)
        return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)

    return generate
