"""The causal Transformer (GPT-2 family) in PyTorch, with three attention
views:

* **training view** (``cfg.decode`` False): dense causal attention over
  the whole sequence;
* **contiguous decode view** (``cfg.decode``, no paging): a chunk of C
  tokens at position ``index`` writes its k/v into a kernel-layout cache
  ``(B, H, max_len, hd)`` and reads it through the K5 kernel
  (``ops/decode_attention.decode_attention``);
* **paged decode view** (``cfg.decode`` and ``paged_num_blocks``): the
  cache is a pool of ``(N, H, block_size, hd)`` blocks shared by every
  request; the chunk's k/v scatter through per-request block tables and
  the K6 kernel (``paged_decode_attention``) reads the pool.

The cache is a list with one dict per layer (``k``, ``v`` and, for an
int8 cache, the f32 scale rows ``ks``, ``vs``); a forward writes the
chunk's rows into it **in place**, so a step function holds one copy of
the cache and no more.

Numerics follow the JAX package's flax modules: params are f32 and cast
to ``cfg.dtype`` at compute, LayerNorm uses eps 1e-6 with its statistics
in f32, the MLP's GELU is the tanh approximation, the attention scores
of the training view are taken in ``cfg.dtype`` with a float32 softmax,
and the LM head runs in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    scatter_chunk,
)

LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)

# knobs of the JAX config that this package does not serve yet, and the
# ROADMAP item (Queue 1) that brings each
_DEFERRED = {
    "lora_rank": "item 7 (multi-LoRA serving)",
    "moe_experts": "item 8 (MoE)",
    "weight_dtype": "item 9 (quantised weights)",
    "tp_axis": "item 14 (tensor parallelism)",
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_len: int = 1024
    causal: bool = True
    dtype: torch.dtype = torch.bfloat16
    decode: bool = False
    kv_dtype: str | None = None  # None (cache at dtype) or "int8"
    paged_num_blocks: int | None = None
    paged_block_size: int | None = None
    # not served yet: setting any of these raises (see _DEFERRED)
    lora_rank: int | None = None
    moe_experts: int | None = None
    weight_dtype: str | None = None
    tp_axis: str | None = None

    def __post_init__(self):
        for knob, item in _DEFERRED.items():
            if getattr(self, knob) is not None:
                raise NotImplementedError(
                    f"{knob} is not ported yet: ROADMAP Queue 1 {item}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"dtype must be torch.float32 or torch.bfloat16, "
                f"got {self.dtype}")
        if self.kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {self.kv_dtype!r}")
        if (self.paged_num_blocks is None) != (self.paged_block_size is None):
            raise ValueError(
                "paged_num_blocks and paged_block_size must be set together")
        if self.paged_block_size is not None:
            if (self.paged_block_size < 1
                    or self.max_len % self.paged_block_size):
                raise ValueError(
                    f"paged_block_size {self.paged_block_size} must divide "
                    f"max_len {self.max_len}")
            if self.paged_num_blocks < 2:
                raise ValueError(
                    "paged_num_blocks must be >= 2 (one is the trash block)")

    @property
    def paged(self) -> bool:
        return self.paged_num_blocks is not None

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads

    @property
    def cache_dtype(self) -> torch.dtype:
        return torch.int8 if self.kv_dtype == "int8" else self.dtype


def gpt2_124m(**kw) -> TransformerConfig:
    """GPT-2 small (124M): 12L, 768d, 12h, causal; vocab 50257 padded to
    50304."""
    return TransformerConfig(
        vocab_size=50304, num_layers=12, num_heads=12, d_model=768,
        d_ff=3072, max_len=1024, causal=True, **kw)


def layer_norm(x, weight, bias, dtype):
    """flax LayerNorm: f32 statistics with the fast variance
    E[x^2] - E[x]^2 (clipped at 0), eps 1e-6, output cast to ``dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * weight
    return ((xf - mean) * mul + bias).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.dtype)


def _linear(x, weight, bias=None, dtype=None):
    """x @ weight.T (+ bias) with both operands cast to ``dtype`` — the
    flax ``Dense(dtype=...)`` rule (f32 params, compute at dtype)."""
    dtype = dtype or x.dtype
    b = None if bias is None else bias.to(dtype)
    return F.linear(x.to(dtype), weight.to(dtype), b)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        h, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
        # rows ordered (3, H, hd) like flax's qkv kernel (D, 3, H, hd)
        self.qkv = nn.Linear(d, 3 * h * hd, bias=False)
        self.proj = nn.Linear(h * hd, d, bias=False)

    def forward(self, x, index=None, *, cache=None, block_tables=None):
        cfg = self.cfg
        B, S, _ = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        qkv = _linear(x, self.qkv.weight, dtype=cfg.dtype)
        qkv = qkv.view(B, S, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, S, H, hd)
        if cfg.decode and cfg.paged:
            out = self._paged_decode_attend(q, k, v, index, cache,
                                            block_tables)
        elif cfg.decode:
            out = self._decode_attend(q, k, v, index, cache)
        else:
            out = self._dense_attend(q, k, v)
        return _linear(out.reshape(B, S, h * hd), self.proj.weight,
                       dtype=cfg.dtype)

    def _dense_attend(self, q, k, v):
        """Training view: scores at cfg.dtype, causal mask with the
        dtype's most negative value, float32 softmax."""
        cfg = self.cfg
        S = q.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
            math.sqrt(cfg.head_dim), dtype=cfg.dtype)
        if cfg.causal:
            mask = torch.ones(S, S, dtype=torch.bool,
                              device=q.device).tril()
            scores = scores.masked_fill(~mask, torch.finfo(cfg.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def _quantized(self, kT, vT):
        k8, k_sc = DA.quantize_kv(kT)
        v8, v_sc = DA.quantize_kv(vT)
        return k8, v8, k_sc[:, :, None, :], v_sc[:, :, None, :]

    def _decode_attend(self, q, k, v, index, cache):
        """Contiguous decode view: write rows [index, index + C) of the
        kernel-layout cache in place, then K5 reads it."""
        if index is None or cache is None:
            raise ValueError("the decode view needs the write index and "
                             "the cache")
        C = q.shape[1]
        index = int(index)
        kT = k.transpose(1, 2)  # (B, H, C, hd)
        vT = v.transpose(1, 2)
        sl = slice(index, index + C)
        ks = vs = None
        if self.cfg.kv_dtype == "int8":
            k8, v8, k_sc, v_sc = self._quantized(kT, vT)
            cache["k"][:, :, sl] = k8
            cache["v"][:, :, sl] = v8
            cache["ks"][..., sl] = k_sc
            cache["vs"][..., sl] = v_sc
            ks, vs = cache["ks"], cache["vs"]
        else:
            cache["k"][:, :, sl] = kT
            cache["v"][:, :, sl] = vT
        return DA.decode_attention(q, cache["k"], cache["v"], index,
                                   key_scale=ks, value_scale=vs)

    def _paged_decode_attend(self, q, k, v, index, cache, block_tables):
        """Paged decode view: scatter the chunk through the block tables
        into the pool in place, then K6 reads the pool. ``index`` is the
        (B,) per-request write position."""
        cfg = self.cfg
        if index is None or block_tables is None or cache is None:
            raise ValueError("paged decode needs the per-request index "
                             "vector, the block tables and the pool")
        B, C = q.shape[:2]
        bs = cfg.paged_block_size
        idx = torch.as_tensor(index, dtype=torch.int32, device=q.device)
        if idx.ndim == 0:
            idx = idx.expand(B)
        kT = k.transpose(1, 2)
        vT = v.transpose(1, 2)
        ks = vs = None
        if cfg.kv_dtype == "int8":
            k8, v8, k_sc, v_sc = self._quantized(kT, vT)
            scatter_chunk(cache["k"], k8, block_tables, idx,
                          block_size=bs, seq_axis=2)
            scatter_chunk(cache["v"], v8, block_tables, idx,
                          block_size=bs, seq_axis=2)
            scatter_chunk(cache["ks"], k_sc, block_tables, idx,
                          block_size=bs, seq_axis=3)
            scatter_chunk(cache["vs"], v_sc, block_tables, idx,
                          block_size=bs, seq_axis=3)
            ks, vs = cache["ks"], cache["vs"]
        else:
            scatter_chunk(cache["k"], kT, block_tables, idx,
                          block_size=bs, seq_axis=2)
            scatter_chunk(cache["v"], vT, block_tables, idx,
                          block_size=bs, seq_axis=2)
        lengths = (idx + C).to(torch.int32)
        return DA.paged_decode_attention(
            q, cache["k"], cache["v"], block_tables, lengths,
            key_scale_pool=ks, value_scale_pool=vs, block_size=bs)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.up = nn.Linear(cfg.d_model, cfg.d_ff, bias=True)
        self.down = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        dt = self.cfg.dtype
        y = _linear(x, self.up.weight, self.up.bias, dtype=dt)
        y = F.gelu(y, approximate="tanh")
        return _linear(y, self.down.weight, dtype=dt)


class Block(nn.Module):
    """Pre-LN block: x + attn(LN(x)); x + mlp(LN(x))."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = MultiHeadAttention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype)
        self.mlp = MLP(cfg)

    def forward(self, x, index=None, *, cache=None, block_tables=None):
        x = x + self.attn(self.ln1(x), index, cache=cache,
                          block_tables=block_tables)
        return x + self.mlp(self.ln2(x))


class Transformer(nn.Module):
    """Tokens in, float32 logits out.

    ``forward(tokens, index=None, *, cache=None, block_tables=None)``:
    ``tokens`` (B, S) int; in decode mode ``index`` is the absolute
    position of ``tokens[:, 0]`` — an int for the contiguous view, a
    (B,) tensor (one position per request) for the paged view — and
    ``cache`` is what :meth:`init_cache` / :meth:`init_pool` returned,
    updated in place.
    """

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)
        self.blocks = nn.ModuleList(Block(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Transformer":
        """Random weights from ``seed`` with the JAX package's
        initialisers: normal(0.02) for every kernel and embedding, zeros
        for biases, ones for LayerNorm scales. Drawn on the CPU with an
        explicit generator, so a seed gives the same weights on every
        device."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self

    def with_config(self, cfg: TransformerConfig) -> "Transformer":
        """A model under another config (the decode and paged views of a
        training model) that shares this one's parameter tensors."""
        with torch.device("meta"):
            view = Transformer(cfg)
        view.load_state_dict(self.state_dict(), assign=True)
        return view

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def init_cache(self, batch_size: int) -> list[dict]:
        """Zeroed contiguous cache, kernel layout (B, H, max_len, hd) per
        layer, plus (B, H, 1, max_len) f32 scales for an int8 cache."""
        cfg = self.cfg
        shape = (batch_size, cfg.num_heads, cfg.max_len, cfg.head_dim)
        scale_shape = (batch_size, cfg.num_heads, 1, cfg.max_len)
        return [self._zeros(shape, scale_shape)
                for _ in range(cfg.num_layers)]

    def init_pool(self) -> list[dict]:
        """Zeroed paged pool, (N, H, block_size, hd) per layer, plus
        (N, H, 1, block_size) f32 scales for an int8 cache."""
        cfg = self.cfg
        if not cfg.paged:
            raise ValueError("init_pool needs a paged config")
        n, bs = cfg.paged_num_blocks, cfg.paged_block_size
        shape = (n, cfg.num_heads, bs, cfg.head_dim)
        return [self._zeros(shape, (n, cfg.num_heads, 1, bs))
                for _ in range(cfg.num_layers)]

    def _zeros(self, shape, scale_shape):
        dev = self.device
        leaf = {"k": torch.zeros(shape, dtype=self.cfg.cache_dtype,
                                 device=dev),
                "v": torch.zeros(shape, dtype=self.cfg.cache_dtype,
                                 device=dev)}
        if self.cfg.kv_dtype == "int8":
            leaf["ks"] = torch.zeros(scale_shape, device=dev)
            leaf["vs"] = torch.zeros(scale_shape, device=dev)
        return leaf

    def forward(self, tokens, index=None, *, cache=None, block_tables=None):
        cfg = self.cfg
        if cfg.decode and index is None:
            raise ValueError("cfg.decode=True requires the position index")
        dt = cfg.dtype
        x = self.tok_emb(tokens).to(dt)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        if cfg.decode:
            # the engine passes one position per request (B,); the
            # one-shot generator a single int
            if isinstance(index, torch.Tensor) and index.ndim:
                positions = positions[None, :] + index[:, None]
            else:
                positions = positions + int(index)
        x = x + self.pos_emb(positions).to(dt)
        for i, blk in enumerate(self.blocks):
            x = blk(x, index, cache=None if cache is None else cache[i],
                    block_tables=block_tables)
        x = self.ln_f(x)
        return _linear(x, self.lm_head.weight, dtype=torch.float32)
