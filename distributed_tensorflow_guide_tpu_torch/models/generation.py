"""Autoregressive generation: the one-shot KV-cache generator and the
samplers the serve engine shares with it.

* The prompt goes through the model in one chunk (the contiguous decode
  view, ``models/transformer.py``), which fills the cache; each later
  token is one more chunk of width 1. The JAX package's ``lax.scan`` is
  one decode step captured as a CUDA graph on the card
  (``core/graphs.CapturedStep``) and replayed once a token, with the
  write index, the token and the position keys in device memory (the
  index advances there); on the CPU the same step runs eagerly. The cache
  is updated in place.
* Speculative decoding (``spec_draft_layers``, ``spec_lookahead``): the
  draft is the first K layers of the same weights with a K-layer cache of
  its own; each round drafts G tokens, verifies them in one (G+1)-row
  chunk through the full model, and emits the verifier's tokens up to and
  including the first mismatch (the accept count is the minimum over the
  batch). The round is one captured graph; the host reads one value a
  round (how far the stream has come), which stands in for the
  reference's ``lax.while_loop`` condition. Rows of rejected drafts stay
  in the caches past the index, where K5 cannot see them.
* Multi-LoRA (``adapters``, ``adapter_id``): one adapter of the bank for
  the whole batch, the engine's per-request oracle.
* Mixture of experts (``cfg.moe_experts``) runs unchanged: the prompt
  chunk is dropless (every token has a seat) and each decode step seats
  ``moe_capacity`` tokens an expert among the batch's rows, so a solo
  (B = 1) run never overflows: it is the MoE engine's per-request
  oracle, whose stalled slots retry until they are seated.
* Sampling: greedy (``temperature == 0``, an exact argmax), temperature,
  and top-k, drawn as the JAX package draws them: the token at absolute
  position p of a request takes the key ``fold_in(rng, p)`` and the
  Gumbel-max draw of ``jax.random.categorical``, through this module's
  own copy of JAX's threefry-2x32 generator (partitionable random bits,
  ``uniform``, ``gumbel``) in int64 operations, numpy or torch as the
  keys are. On the card every draw stays on the device (the noise of the
  whole row, -inf columns included, which cannot win), so a sampled step
  can be captured; on the CPU, top-k draws the noise of its surviving
  columns alone (their bits on the host, after a ``nonzero``), bitwise
  the same token. A sampled token is then a pure function of (request
  key, position, logits): the serve engine, which interleaves requests in
  any order and batch width, emits each request's stream bitwise as this
  generator does for the request alone, speculative decoding emits the
  vanilla stream, and the streams are the JAX package's token for token
  wherever the logits agree.
* The engine's streams equal this generator's bitwise on the CPU always,
  and on the card only where both prefill a prompt in the same regime:
  a prompt the engine takes in one chunk and this generator in one chunk
  of ``CHUNK_MIN_ROWS`` (10) to 64 rows, where both run K5/K6's tensor-
  core regime and cuBLAS gives every row the bits of a one-row product.
  A shorter prompt (K5's split regime, another summation order) or one
  the engine takes in several chunks runs other kernels on each side,
  and the streams then agree to rounding, not bitwise. The decode steps
  of both (K5's and K6's split regime) cut the keys into splits of one
  count, the tuning table's ``decode_split`` entry, which each resolves
  once before its first capture (:func:`decode_split_config`): a tuned
  count keeps them bitwise equal.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.graphs import CapturedStep
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY32 = float(np.finfo(np.float32).tiny)


def decode_config(cfg: TransformerConfig) -> TransformerConfig:
    """The serving view of a training config: KV-cache attention."""
    return dataclasses.replace(cfg, decode=True)


def decode_split_config(cfg: TransformerConfig, device, *, batch: int,
                        block_size: int | None = None,
                        n_blk: int | None = None) -> TransformerConfig:
    """``cfg`` with the keys a split of K5/K6 resolved once
    (``ops/decode_attention.resolve_split_keys``: the tuning table's
    ``decode_split`` entry, which the engine (K6) and the one-shot (K5)
    share, or its online sweep at ``batch`` rows; the fixed rule on the
    CPU). Called before any graph is captured; the views keep it."""
    if cfg.decode_split_keys is not None:
        return cfg
    keys = DA.resolve_split_keys(
        h=cfg.num_heads, hd=cfg.head_dim, kv_dtype=cfg.cache_dtype,
        q_dtype=cfg.dtype, device=device, b=batch, s=cfg.max_len,
        block_size=block_size, n_blk=n_blk)
    return dataclasses.replace(cfg, decode_split_keys=keys)


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
        if isinstance(x, torch.Tensor):
            x = x.to(device=like.device, dtype=torch.int64)
        elif np.ndim(x) == 0:  # a fill, not a copy: capturable
            return torch.full((), int(x) & _MASK32, dtype=torch.int64,
                              device=like.device)
        else:
            x = torch.as_tensor(np.asarray(x, np.int64), device=like.device)
        return x & _MASK32
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
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
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




def _device_keys(keys, device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(keys, np.int64), device=device)


def _sample(logits, key, temperature: float, top_k: int | None):
    """(B, V) float32 logits -> (B,) int64 tokens. Greedy when
    ``temperature == 0`` (an exact argmax); else
    ``jax.random.categorical(key, logits)``: one (2,) key (host or
    tensor) for the whole call, Gumbel noise of shape (B, V) (row b draws
    counts b * V + v). With ``top_k``, CPU logits draw the noise at the
    surviving columns alone (:func:`_gumbel_max_live`, a sync); CUDA
    logits draw the whole row on the device, so the step can be captured
    in a CUDA graph: the same token."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _tempered(logits, temperature, top_k)
    B, V = logits.shape
    if top_k is not None and logits.device.type == "cpu":
        return _gumbel_max_live(
            logits, np.broadcast_to(_host(key), (B, 2)), V)
    key = _device_keys(key, logits.device)
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


def sample_rows(logits, keys, temperature: float, top_k: int | None):
    """Per-row sampling with (B, 2) keys (host or tensor): row b is
    bitwise what a B=1 :func:`_sample` call with key b emits — the
    engine's sampler. Top-k draws as in :func:`_sample`."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _tempered(logits, temperature, top_k)
    if top_k is not None and logits.device.type == "cpu":
        return _gumbel_max_live(logits, _host(keys), 0)
    keys = _device_keys(keys, logits.device)
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


# --------------------------------------------------------------------------
# the one-shot generator
# --------------------------------------------------------------------------


class _Loop:
    """One batch size's decode loop for one set of weights: the model
    views (the draft's too, with speculative decoding), their caches, the
    static tensors the step reads and writes (the token, the write index,
    the position keys, the output row), and the step itself — a vanilla
    decode step or a speculative round — captured as a CUDA graph when
    ``capture``. The capture happens here, before any call has set the
    state up: its warm-up runs on zeros that every call overwrites."""

    def __init__(self, g: "_Settings", model: Transformer, batch: int,
                 capture: bool):
        self.g = g
        dev = model.device
        self.dm = model.with_config(g.dcfg)
        if g.adapters is not None:
            self.dm.set_adapter_bank(g.adapters)
        self.caches = [self.dm.init_cache(batch)]
        L = g.dcfg.max_len
        self.keys = torch.zeros(L + 1, 2, dtype=torch.int64, device=dev)
        self.out = torch.zeros(batch, L, dtype=torch.int64, device=dev)
        self.tok = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.idx = torch.zeros(1, dtype=torch.int32, device=dev)
        self.ids = (torch.full((batch,), g.adapter_id, dtype=torch.int64,
                               device=dev) if g.adapters is not None
                    else None)
        if g.draft_cfg is not None:
            self.dd = model.with_config(g.draft_cfg)
            self.caches.append(self.dd.init_cache(batch))
        fn = self._round if g.draft_cfg is not None else self._decode_step
        self.step = CapturedStep(fn, device=dev) if capture else fn
        if capture:
            self.step.capture()

    def _pick(self, logits, pos):
        """Sample position ``pos`` ((1,) int64 on the device) from (B, V)
        logits with that position's key, read on the device."""
        key = (self.keys.index_select(0, pos).view(2) if self.g.sampled
               else None)
        return _sample(logits, key, self.g.temperature, self.g.top_k)

    def _decode_step(self):
        """Feed ``tok`` at position ``idx``, sample position idx + 1 into
        the output row, advance ``idx``."""
        logits = self.dm(self.tok[:, None], self.idx, cache=self.caches[0],
                         adapter=self.ids)
        pos = self.idx.to(torch.int64) + 1
        nxt = self._pick(logits[:, -1], pos)
        self.out.index_copy_(1, pos, nxt[:, None])
        self.tok.copy_(nxt)
        self.idx.add_(1)

    def _round(self):
        """One speculative round from ``tok`` (the last emitted token, at
        ``idx``, its k/v not yet written): G + 1 draft steps (the last
        only writes its k/v, so a fully accepted round leaves no hole in
        the draft cache), one (G + 1)-row verify chunk through the full
        model, the verifier's tokens into the output row, ``idx``
        advanced past the accepted drafts and the verifier's next
        token."""
        G = self.g.lookahead
        dcache = self.caches[1]
        pos = self.idx.to(torch.int64)
        dtok, didx, drafts = self.tok, self.idx, []
        for j in range(G + 1):
            if j < G:
                dl = self.dd(dtok[:, None], didx, cache=dcache)
                dtok = self._pick(dl[:, -1], didx.to(torch.int64) + 1)
                drafts.append(dtok)
            else:
                self.dd(dtok[:, None], didx, cache=dcache,
                        return_hidden=True)
            didx = didx + 1
        drafts = torch.stack(drafts, dim=1)  # (B, G)
        chunk = torch.cat([self.tok[:, None], drafts], dim=1)
        vl = self.dm(chunk, self.idx, cache=self.caches[0])
        verified = torch.stack([self._pick(vl[:, j], pos + 1 + j)
                                for j in range(G + 1)], dim=1)
        # the longest accepted prefix of each row, the batch's minimum
        ok = (verified[:, :G] == drafts).to(torch.int64)
        m = ok.cumprod(dim=1).sum(dim=1).amin()
        cols = pos + 1 + torch.arange(G + 1, device=pos.device)
        self.out.index_copy_(1, cols, verified)
        self.tok.copy_(verified.gather(
            1, m.view(1, 1).expand(verified.shape[0], 1))[:, 0])
        self.idx.add_((m + 1).to(torch.int32))

    def run(self, prompt: torch.Tensor, rng
            ) -> tuple[torch.Tensor, dict | None]:
        g = self.g
        P = prompt.shape[1]
        for cache in self.caches:  # a fresh cache per call
            for layer in cache:
                for t in layer.values():
                    t.zero_()
        if g.sampled:  # every position's key, folded on the host at once
            key = np.asarray(rng, np.uint32).astype(np.int64)
            self.keys.copy_(torch.from_numpy(
                fold_in(key, np.arange(self.keys.shape[0]))))
        self.idx.zero_()
        logits = self.dm(prompt, self.idx, cache=self.caches[0],
                         adapter=self.ids)
        if g.draft_cfg is not None:
            self.dd(prompt, self.idx, cache=self.caches[1],
                    return_hidden=True)
        first = self._pick(logits[:, -1], torch.full(
            (1,), P, dtype=torch.int64, device=prompt.device))
        self.out[:, :P] = prompt
        self.out[:, P] = first
        self.tok.copy_(first)
        self.idx.fill_(P)
        stats = None
        if g.draft_cfg is None:
            for _ in range(g.max_new_tokens - 1):
                self.step()
        else:
            rounds, produced = 0, 1
            while produced < g.max_new_tokens:
                self.step()
                rounds += 1
                produced = int(self.idx.item()) - P + 1  # one read a round
            stats = {"verify_steps": rounds,
                     "accepted_drafts": produced - 1 - rounds}
        return self.out[:, :P + g.max_new_tokens].clone(), stats


@dataclasses.dataclass(frozen=True, eq=False)
class _Settings:
    dcfg: TransformerConfig
    draft_cfg: TransformerConfig | None
    lookahead: int
    max_new_tokens: int
    temperature: float
    top_k: int | None
    adapters: dict | None
    adapter_id: int

    @property
    def sampled(self) -> bool:
        return self.temperature != 0.0


_LOOPS_KEPT = 4  # batch sizes / weight sets a generator keeps captured


def make_generate_fn(cfg: TransformerConfig, *, max_new_tokens: int,
                     temperature: float = 1.0, top_k: int | None = None,
                     spec_draft_layers: int = 0, spec_lookahead: int = 4,
                     adapters=None, adapter_id: int = 0, device=None):
    """Build ``generate(model, prompt (B, P), rng (2,) uint32) -> (B, P +
    max_new_tokens)``: prefill the prompt in one chunk, then decode one
    token per step through the K5 kernel. ``model`` holds the weights (a
    :class:`Transformer` of ``cfg``'s widths, any view) on ``device``
    (default the first CUDA card). ``P + max_new_tokens`` (+ the
    lookahead with speculative decoding) must fit ``cfg.max_len``.

    On the card the decode step (or the speculative round) is captured
    as a CUDA graph the first time a batch size meets a set of weights,
    and replayed from then on; ``generate.captures`` counts the captures.
    ``generate.eager`` runs the same steps without a graph (the card's
    bitwise comparison); on the CPU both are eager.

    * ``spec_draft_layers`` K > 0 turns speculative decoding on: the draft
      is the first K layers of the same weights (its own K-layer cache);
      ``spec_lookahead`` G drafts are verified a round in one (G + 1)-row
      chunk, and the stream is the vanilla one, token for token, greedy
      or sampled. ``generate.last_stats`` then holds ``verify_steps`` and
      ``accepted_drafts`` of the last call.
    * ``adapters`` (with ``cfg.lora_rank``): the delta banks, name ->
      array, as :func:`serve.engine.init_adapter_bank` names them;
      ``adapter_id`` picks the row the whole batch uses.

    The keys a split of K5's split regime are resolved at the first call,
    before its capture, and kept (:func:`decode_split_config`: the entry
    the serve engine reads too).
    """
    spec = spec_draft_layers > 0
    if spec and not 0 < spec_draft_layers < cfg.num_layers:
        raise ValueError(
            f"spec_draft_layers {spec_draft_layers} must lie strictly "
            f"between 0 and num_layers {cfg.num_layers} (the draft is a "
            "proper prefix of the same model)")
    if spec and spec_lookahead < 1:
        raise ValueError(f"spec_lookahead {spec_lookahead} must be >= 1")
    lora = cfg.lora_rank is not None
    if lora and adapters is None:
        raise ValueError(
            "cfg.lora_rank set: pass the adapters bank "
            "(serve.init_adapter_bank)")
    if not lora and adapters is not None:
        raise ValueError("adapters given but cfg.lora_rank is None")
    if lora and not 0 <= adapter_id <= cfg.lora_adapters:
        raise ValueError(
            f"adapter_id {adapter_id} out of range "
            f"[0, {cfg.lora_adapters}]")
    if lora and spec:
        raise ValueError("speculative decoding + LoRA is not supported")
    dcfg = decode_config(cfg)
    dev = resolve_device(device)
    g = _Settings(
        dcfg=dcfg,
        draft_cfg=(decode_config(dataclasses.replace(
            cfg, num_layers=spec_draft_layers)) if spec else None),
        lookahead=spec_lookahead if spec else 0,
        max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, adapters=adapters, adapter_id=adapter_id)
    loops: dict = {}
    resolved: list = []  # the settings with the keys a split, once

    def loop_for(model: Transformer, batch: int, capture: bool) -> _Loop:
        # the weights by address: a graph reads them there
        key = (batch, capture,
               tuple(p.data_ptr() for p in model.parameters()))
        hit = loops.get(key)
        if hit is not None and hit[0]() is model:
            return hit[1]
        while len(loops) >= _LOOPS_KEPT:
            loops.pop(next(iter(loops)))
        if not resolved:
            dc = decode_split_config(dcfg, dev, batch=batch)
            resolved.append(dataclasses.replace(
                g, dcfg=dc, draft_cfg=None if g.draft_cfg is None else
                dataclasses.replace(g.draft_cfg,
                                    decode_split_keys=dc.decode_split_keys)))
        loop = _Loop(resolved[0], model, batch, capture)
        if capture:
            generate.captures += loop.step.captures
        loops[key] = (weakref.ref(model), loop)
        return loop

    @torch.inference_mode()
    def run(model: Transformer, prompt, rng, capture: bool) -> torch.Tensor:
        if model.device != dev:
            raise ValueError(f"model lives on {model.device}, generator "
                             f"on {dev}")
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=dev)
        B, P = prompt.shape
        budget = max_new_tokens + g.lookahead
        if P + budget > dcfg.max_len:
            raise ValueError(
                f"prompt {P} + max_new_tokens {max_new_tokens}"
                + (f" + spec_lookahead {spec_lookahead}" if spec else "")
                + f" exceeds max_len {dcfg.max_len}")
        out, stats = loop_for(model, B, capture).run(prompt, rng)
        generate.last_stats = stats
        return out

    def generate(model: Transformer, prompt, rng) -> torch.Tensor:
        return run(model, prompt, rng, capture=dev.type == "cuda")

    generate.eager = lambda model, prompt, rng: run(model, prompt, rng,
                                                    capture=False)
    # the eager loop ``generate.eager`` runs for (model, batch): its caches
    # are the state the program auditor's contracts name
    generate.eager_loop = lambda model, batch: loop_for(model, batch,
                                                        capture=False)
    generate.captures = 0
    generate.last_stats = None
    return generate


def lint_contracts():
    """Contracts for the one-shot generator's programs (vanilla and
    speculative), each one ``generate.eager`` call: the prompt chunk and
    the decode steps (the eager body of the step the card captures).

    Collective-free (it runs on one device or replicated), free of host
    syncs and global draws (tokens are sampled with threefry from the
    request's key), and the caches are ``scratch`` state: zeroed and
    refilled in place each call, read by K5, never copied whole. The
    speculative round reads one value a round on the host
    (``int(idx.item())``, the stream's length, standing in for the JAX
    package's ``lax.while_loop`` condition): its contract allows exactly
    that, once a round. A round emits 1 to G + 1 tokens, so the 3 tokens
    after the prompt's take 1 to 3 rounds."""
    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        CostSpec,
        DonationSpec,
        ProgramContract,
    )

    B, P, MAX_NEW = 2, 8, 4

    def build(spec_layers):
        def _build(device):
            from distributed_tensorflow_guide_tpu_torch.analysis.fixtures import (  # noqa: E501
                tiny_lm,
                tiny_lm_cfg,
            )

            cfg = tiny_lm_cfg(max_len=32)
            gen = make_generate_fn(
                cfg, max_new_tokens=MAX_NEW, spec_draft_layers=spec_layers,
                spec_lookahead=2 if spec_layers else 4, device=device)
            model = tiny_lm(cfg, device)
            prompt = np.random.RandomState(1).randint(
                0, cfg.vocab_size, (B, P)).astype(np.int32)
            rng = np.array([0, 0], np.uint32)
            caches = gen.eager_loop(model, B).caches

            def program(model, prompt, *rest):
                return gen.eager(model, prompt, rest[-1])

            return program, (model, prompt, *caches, rng)

        return _build

    common = dict(
        policy="f32",
        collectives={},  # strict: the serve path is collective-free
        sources=("distributed_tensorflow_guide_tpu_torch.models.generation",
                 "distributed_tensorflow_guide_tpu_torch.models.transformer",
                 "distributed_tensorflow_guide_tpu_torch.ops."
                 "decode_attention"),
    )
    return [
        ProgramContract(
            name="decode_step",
            build=build(0),
            donation=DonationSpec(argnums=(2,), mode="scratch"),
            # 55,392 observed on the CPU census (weights 28,672 + the
            # cache's 16,384 + the run's tensors): a second copy of the
            # cache held live adds 16,384 and fails it
            cost=CostSpec(max_peak_live_bytes=65536),
            notes="one-shot decode: cache zeroed and refilled in place",
            **common),
        ProgramContract(
            name="decode_spec_step",
            build=build(1),
            donation=DonationSpec(argnums=(2, 3), mode="scratch"),
            allowed_callbacks={"_local_scalar_dense": (1, MAX_NEW - 1)},
            # 64,576 observed on the CPU census (+ the draft's 8,192-byte
            # cache over decode_step's)
            cost=CostSpec(max_peak_live_bytes=73728),
            notes="self-speculative decode: one host read a round",
            **common),
    ]
