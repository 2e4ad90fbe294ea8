"""The causal Transformer (GPT-2 family) in PyTorch, with three attention
views:

* **training view** (``cfg.decode`` False): causal attention over the
  whole sequence, dense or through the flash kernels K1-K3
  (``ops/flash_attention.flash_attention``) as ``cfg.attn_impl``
  resolves, with optional activation checkpointing (``remat_mode``);
* **contiguous decode view** (``cfg.decode``, no paging): a chunk of C
  tokens at position ``index`` writes its k/v into a kernel-layout cache
  ``(B, H, max_len, hd)`` and reads it through the K5 kernel
  (``ops/decode_attention.decode_attention``). ``index`` may be a device
  tensor: the write and the kernel take it there, so one captured CUDA
  graph serves every position;
* **paged decode view** (``cfg.decode`` and ``paged_num_blocks``): the
  cache is a pool of ``(N, H, block_size, hd)`` blocks shared by every
  request; the chunk's k/v scatter through per-request block tables and
  the K6 kernel (``paged_decode_attention``) reads the pool.

With ``cfg.num_classes`` set the model is a sequence classifier (BERT,
``bert_base``): the first position's final hidden state goes through an
f32 ``classifier`` with a bias, and there is no LM head and no decode
view.

Manual tensor parallelism (``cfg.tp_axis``, ``TransformerConfig.tp_local``,
``parallel/tensor.py``): each rank of the ``model`` axis builds the module
with its local head and feed-forward counts (the head dim stays the global
one, ``override_head_dim``) and Megatron's ``f``/``g`` pair
(``collectives.tp_identity`` / ``tp_allreduce``) brackets each sub-layer.
The token embedding and the LM head are then this rank's vocabulary
shard (``vocab_size`` of the local config is V / tp): the embedding looks
up the tokens its shard owns and sums the shards (``vocab_parallel_embed``),
and the LM logits are the shard's columns.

Megatron sequence parallelism (``cfg.tp_sequence``, the JAX package's
``MEGATRON_SP_RULES``): between the sub-layers the residual stream is
this rank's slice of the sequence, (B, S / tp, D), and so are LayerNorm,
the residual adds and the positions added. ``collectives.sp_all_gather``
takes the place of ``f`` (all-gather along S forward, reduce-scatter
backward) and ``sp_reduce_scatter`` that of ``g``; the embedding's sum is
a reduce-scatter, and the final LayerNorm's output is all-gathered before
the head. Attention runs on the whole sequence at the local heads. The
LayerNorms' and ``pos_emb``'s gradients then hold only this slice's part:
``parallel/tensor.py`` sums them over ``model``.

Multi-LoRA serving (``cfg.lora_rank``, ``cfg.lora_adapters``): each of
the four projections (``qkv``, ``proj``, ``up``, ``down``) carries a bank
of ``lora_adapters + 1`` low-rank pairs, buffers ``<site>_A``
``(n, d_in, r)`` and ``<site>_B`` ``(n, r, d_out)`` in ``cfg.dtype`` (row
0 zero: the base model). A call that passes ``adapter`` ((B,) int ids)
adds ``x @ A[id] @ B[id]`` per request, one gathered pair of products for
every adapter in the batch. The banks are buffers, not parameters: the
LoRA path is a serving feature and has no gradient, and new adapter
weights are written into the same tensors in place.

Quantised weights. ``cfg.weight_dtype`` ("int8", "int4", "fp8"; serving)
stores the five projections (``qkv``, ``proj``, ``up``, ``down``,
``lm_head``) as :class:`WeightQuantLinear`: a ``qkernel`` buffer (int8,
int4 packed two a byte into uint8, or e4m3) of the reference's (d_in[/2],
d_out) layout and an f32 per-output-column ``scale``, the reference's
``WeightQuantDense``; ``ops/quant.quantize_params`` (or
:meth:`Transformer.quantize`) makes them from an f32 model.
``cfg.quantized_matmuls`` / ``cfg.fp8_matmuls`` (training; the ``int8`` /
``fp8`` precision presets) keep the f32 ``nn.Linear`` parameters and run
the products of ``qkv``, ``proj``, ``up`` and ``down`` through
``ops/quant.int8_ste_dot`` / ``fp8_ste_dot``, the reference's
``QuantTrainDense``; the head stays at full precision.

Mixture of experts (``cfg.moe_experts``, ``cfg.moe_capacity``; serving,
as in the reference, where ``models/moe_lm.SwitchLM`` owns MoE training):
each block's FFN is a routed top-1 :class:`MoEMLP` over an f32 router and
two expert banks (``mlp.w_in.weight`` (E, d, ff), ``mlp.w_out.weight``
(E, ff, d); ``qkernel`` / ``scale`` banks under ``weight_dtype``). A
decode call (one token a row) seats ``moe_capacity`` tokens an expert and
reports the rows past it (``moe_census``); the serve engine retries them
(``serve/engine.py``). Every other call is dropless. The router's logits
are row-invariant (:func:`router_logits`), and the dispatch is index
algebra with no data-dependent shape, so the engine's steps stay
captured.

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
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import resolve_axis
from distributed_tensorflow_guide_tpu_torch.models.initializers import (
    lecun_normal,
)
from distributed_tensorflow_guide_tpu_torch.models.losses import (
    accuracy,
    cross_entropy_loss,
)
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as FA
from distributed_tensorflow_guide_tpu_torch.ops import quant
from distributed_tensorflow_guide_tpu_torch.parallel import expert as EP
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    scatter_chunk,
)

LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


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
    # activation checkpointing of the training view: "none", "attention"
    # (only the attention sub-layer) or "block" (each whole block)
    remat_mode: str = "none"
    # set: a classification head over the first ([CLS]) position
    num_classes: int | None = None
    # "dense" (scores at dtype, f32 softmax), "flash" (K1-K3; on the CPU
    # it falls back to the blockwise path on shapes the JAX block rule
    # does not take) or "auto": flash for causal sequences of 1024 tokens
    # or more
    attn_impl: str = "auto"
    # manual tensor parallelism: the mesh axis of the f/g pair; the config
    # then holds this rank's local head / ff counts (``tp_local``), with
    # the global head dim pinned by ``override_head_dim``
    tp_axis: str | None = None
    override_head_dim: int | None = None
    # Megatron sequence parallelism between the sub-layers (with tp_axis)
    tp_sequence: bool = False
    # multi-LoRA serving: a bank of lora_adapters + 1 rank-lora_rank delta
    # pairs per projection, row 0 zero (the base model)
    lora_rank: int | None = None
    lora_adapters: int = 0
    # weight-only quantised serving: "int8", "int4" or "fp8" projections
    # (ops/quant.quantize_params makes the weights)
    weight_dtype: str | None = None
    # int8 / fp8 training products with straight-through gradients
    # (ops/quant.int8_ste_dot / fp8_ste_dot; core/precision.py's presets)
    quantized_matmuls: bool = False
    fp8_matmuls: bool = False
    # routed top-1 MoE FFN (MoEMLP): the expert count, and the seats an
    # expert has in a one-token-a-row (decode) call; None: every call is
    # dropless
    moe_experts: int | None = None
    moe_capacity: int | None = None
    # keys a split of K5/K6's split regime (decode views): None reads the
    # tuning table's ``decode_split`` entry at each call; the engine and
    # the one-shot resolve it once, before any graph is captured
    # (``models/generation.decode_split_config``)
    decode_split_keys: int | None = None

    def __post_init__(self):
        if self.weight_dtype not in (None, "int8", "int4", "fp8"):
            raise ValueError(
                "weight_dtype must be None, 'int8', 'int4' or 'fp8', "
                f"got {self.weight_dtype!r}")
        if self.weight_dtype is not None:
            if self.quantized_matmuls:
                raise ValueError(
                    "weight_dtype (decode-side) and quantized_matmuls "
                    "(training-side) are mutually exclusive")
            if self.fp8_matmuls:
                raise ValueError(
                    "weight_dtype (decode-side) and fp8_matmuls "
                    "(training-side) are mutually exclusive")
        if self.quantized_matmuls or self.fp8_matmuls:
            lever = ("quantized_matmuls" if self.quantized_matmuls
                     else "fp8_matmuls")
            if self.quantized_matmuls and self.fp8_matmuls:
                raise ValueError(
                    "quantized_matmuls and fp8_matmuls are mutually "
                    "exclusive — one quantized representation per model")
            if self.decode:
                raise ValueError(
                    f"{lever} is the training lever; decode-side "
                    "quantization is weight_dtype")
            if self.lora_rank is not None:
                raise ValueError(
                    f"{lever} and lora_rank are mutually exclusive")
        if self.lora_rank is not None:
            if self.lora_rank < 1:
                raise ValueError(
                    f"lora_rank must be >= 1, got {self.lora_rank}")
            if self.lora_adapters < 1:
                raise ValueError(
                    "lora_rank set requires lora_adapters >= 1 "
                    f"(got {self.lora_adapters})")
            if self.weight_dtype is not None:
                raise ValueError(
                    "weight_dtype and lora_rank are mutually exclusive "
                    "(the quantized projections have no f32 kernel for "
                    "the deltas to ride on)")
        elif self.lora_adapters:
            raise ValueError("lora_adapters requires lora_rank")
        if self.moe_capacity is not None and self.moe_experts is None:
            raise ValueError("moe_capacity requires moe_experts")
        if self.moe_experts is not None:
            if self.moe_experts < 2:
                raise ValueError(
                    f"moe_experts must be >= 2, got {self.moe_experts}")
            if self.moe_capacity is not None and self.moe_capacity < 1:
                raise ValueError(
                    f"moe_capacity must be >= 1, got {self.moe_capacity}")
            if self.lora_rank is not None:
                raise ValueError(
                    "moe_experts and lora_rank are mutually exclusive "
                    "(no delta bank wiring on the routed FFN)")
            if self.quantized_matmuls or self.fp8_matmuls:
                raise ValueError(
                    "moe_experts and the training quant levers are "
                    "mutually exclusive (SwitchLM owns MoE training)")
            if self.tp_axis:
                raise ValueError(
                    "moe_experts and tp_axis are mutually exclusive "
                    "(expert parallelism is the MoE sharding story)")
        if self.attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(
                "attn_impl must be 'auto', 'dense' or 'flash', "
                f"got {self.attn_impl!r}")
        if self.remat_mode not in ("none", "attention", "block"):
            raise ValueError(
                "remat_mode must be 'none', 'attention' or 'block', "
                f"got {self.remat_mode!r}")
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
        if self.tp_sequence and (self.tp_axis is None or self.decode
                                 or self.num_classes is not None):
            raise ValueError(
                "tp_sequence needs tp_axis, and takes neither the decode "
                "views nor a classification head")
        if self.num_classes is not None and self.decode:
            raise ValueError(
                "a classification config (num_classes) has no serving "
                "view: the engine and the generator need an LM head")
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
    def lora(self) -> bool:
        return self.lora_rank is not None

    @property
    def moe(self) -> bool:
        return self.moe_experts is not None

    @property
    def train_quant(self) -> str | None:
        """The quantised training product ("int8", "fp8") or None."""
        if self.quantized_matmuls:
            return "int8"
        return "fp8" if self.fp8_matmuls else None

    def resolve_attn_impl(self, seq_len: int | None = None) -> str:
        """Resolve 'auto' against the sequence length (``max_len`` when
        none is given)."""
        if self.attn_impl != "auto":
            return self.attn_impl
        s = self.max_len if seq_len is None else seq_len
        return "flash" if (self.causal and s >= 1024) else "dense"

    @property
    def head_dim(self) -> int:
        if self.override_head_dim is not None:
            return self.override_head_dim
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads

    def tp_local(self, tp: int, axis: str = "model") -> "TransformerConfig":
        """This config as one shard of ``tp``-way manual tensor
        parallelism sees it: local head and ff counts, the global head dim
        pinned, the f/g pair on ``axis``."""
        if self.num_heads % tp or self.d_ff % tp:
            raise ValueError(
                f"num_heads={self.num_heads} and d_ff={self.d_ff} must both "
                f"divide by tp={tp}")
        return dataclasses.replace(
            self, num_heads=self.num_heads // tp, d_ff=self.d_ff // tp,
            override_head_dim=self.head_dim, tp_axis=axis)

    @property
    def cache_dtype(self) -> torch.dtype:
        return torch.int8 if self.kv_dtype == "int8" else self.dtype


def check_placement(cfg: TransformerConfig, device) -> None:
    """Refuse, where the model meets the card, a head dim wider than the
    port's kernels take (``ops/flash_attention.MAX_HEAD_DIM``, the limit
    of all six); the CPU's plain versions take any."""
    if (torch.device(device).type == "cuda"
            and cfg.head_dim > FA.MAX_HEAD_DIM):
        raise ValueError(
            f"head_dim {cfg.head_dim} (d_model {cfg.d_model} / "
            f"{cfg.num_heads} heads): the CUDA kernels take head dims up "
            f"to {FA.MAX_HEAD_DIM}")


def gpt2_124m(**kw) -> TransformerConfig:
    """GPT-2 small (124M): 12L, 768d, 12h, causal; vocab 50257 padded to
    50304."""
    return TransformerConfig(
        vocab_size=50304, num_layers=12, num_heads=12, d_model=768,
        d_ff=3072, max_len=1024, causal=True, **kw)


def bert_base(num_classes: int = 2, **kw) -> TransformerConfig:
    """BERT-base (110M): 12L, 768d, 12h, bidirectional, a classification
    head; vocab 30522 padded to 30592."""
    return TransformerConfig(
        vocab_size=30592, num_layers=12, num_heads=12, d_model=768,
        d_ff=3072, max_len=512, causal=False, num_classes=num_classes, **kw)


def row_sum(x):
    """Sum over the last axis with the same bits for a row whatever the
    number of rows. PyTorch's CUDA reduction picks its threads per row from
    the row count (128 lanes for 4 rows, 32 for 20), which changes the
    order of the sum; a decode step (B rows), a speculative verify chunk
    (B x (G + 1) rows) and an engine step (slots rows) would then give one
    request other bits. Summed as (rows, D / 32, 32) -> 32-lane sums ->
    (rows, D / 32) -> row sums, every level has enough outputs that the
    lanes per output no longer depend on the row count."""
    d = x.shape[-1]
    if d % 32 or d == 32:
        return x.sum(dim=-1)
    return x.unflatten(-1, (d // 32, 32)).sum(dim=-1).sum(dim=-1)


def layer_norm(x, weight, bias, dtype, row_invariant: bool = False):
    """flax LayerNorm: f32 statistics with the fast variance
    E[x^2] - E[x]^2 (clipped at 0), eps 1e-6, output cast to ``dtype``.
    ``row_invariant`` takes the means through :func:`row_sum` (the decode
    views: a request's bits must not depend on its batch-mates; the
    training view keeps the one-pass mean, two kernels fewer a norm)."""
    xf = x.float()
    if row_invariant:
        d = xf.shape[-1]
        mean = row_sum(xf)[..., None] / d
        sq = row_sum(xf * xf)[..., None] / d
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        sq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(sq - mean * mean, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * weight
    return ((xf - mean) * mul + bias).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype,
                 row_invariant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.row_invariant = row_invariant
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.dtype,
                          self.row_invariant)


def _linear(x, weight, bias=None, dtype=None):
    """x @ weight.T (+ bias) with both operands cast to ``dtype`` — the
    flax ``Dense(dtype=...)`` rule (f32 params, compute at dtype)."""
    dtype = dtype or x.dtype
    b = None if bias is None else bias.to(dtype)
    return F.linear(x.to(dtype), weight.to(dtype), b)


def _quant_storage(d_in: int, weight_dtype: str):
    """``(bits, stored rows, storage dtype)`` of a quantised kernel of fan-in
    ``d_in``: int8, two int4 values a byte (uint8), or e4m3."""
    bits = quant.WQ_BITS[weight_dtype]
    if bits == 4:
        if d_in % 2:
            raise ValueError(f"int4 packing needs an even fan-in, got {d_in}")
        return bits, d_in // 2, torch.uint8
    return bits, d_in, quant.FP8_DTYPE if bits == "fp8" else torch.int8


class WeightQuantLinear(nn.Module):
    """A weight-only quantised projection (``cfg.weight_dtype``), the
    reference's ``WeightQuantDense``: buffers ``qkernel`` (d_in, d_out)
    int8, (d_in / 2, d_out) uint8 for int4, or e4m3, and ``scale``
    (d_out,) f32, the layout ``ops/quant.quantize_params`` writes; an f32
    ``bias`` parameter where the f32 projection has one. Zeros and ones
    until quantised weights are loaded."""

    def __init__(self, d_in: int, d_out: int, weight_dtype: str, *,
                 bias: bool = False):
        super().__init__()
        self.bits, rows, store = _quant_storage(d_in, weight_dtype)
        self.register_buffer("qkernel", torch.zeros(rows, d_out,
                                                    dtype=store))
        self.register_buffer("scale", torch.ones(d_out))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x, dtype):
        y = quant.wq_matmul(x, self.qkernel, self.scale, bits=self.bits,
                            dtype=dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def _projection(cfg: TransformerConfig, d_in: int, d_out: int, *,
                bias: bool = False) -> nn.Module:
    """A projection site's module: ``nn.Linear`` (f32 weights), or a
    :class:`WeightQuantLinear` under ``cfg.weight_dtype``."""
    if cfg.weight_dtype:
        return WeightQuantLinear(d_in, d_out, cfg.weight_dtype, bias=bias)
    return nn.Linear(d_in, d_out, bias=bias)


def _project(cfg: TransformerConfig, lin: nn.Module, x, dtype,
             *, head: bool = False):
    """``lin`` applied to ``x`` at ``dtype``: a quantised serving
    projection through ``wq_matmul``; under ``quantized_matmuls`` /
    ``fp8_matmuls`` (not the head) the product through
    ``int8_ste_dot`` / ``fp8_ste_dot`` on the operands cast to ``dtype``,
    bias added at ``dtype``; else :func:`_linear`."""
    if isinstance(lin, WeightQuantLinear):
        return lin(x, dtype)
    mode = None if head else cfg.train_quant
    if mode is None:
        return _linear(x, lin.weight, lin.bias, dtype=dtype)
    dot = quant.fp8_ste_dot if mode == "fp8" else quant.int8_ste_dot
    y = dot(x.to(dtype), lin.weight.to(dtype).t()).to(dtype)
    if lin.bias is not None:
        y = y + lin.bias.to(dtype)
    return y


def _tp_enter(x, cfg: TransformerConfig):
    """A sub-layer's input under tensor parallelism: Megatron's ``f``
    (identity forward, psum backward), or under sequence parallelism the
    all-gather along S (reduce-scatter backward)."""
    if not cfg.tp_axis:
        return x
    if cfg.tp_sequence:
        return cc.sp_all_gather(x, cfg.tp_axis, dim=1)
    return cc.tp_identity(x, cfg.tp_axis)


def _tp_leave(y, cfg: TransformerConfig):
    """A sub-layer's row-parallel output: Megatron's ``g`` (psum forward,
    identity backward), or under sequence parallelism the reduce-scatter
    along S (all-gather backward)."""
    if not cfg.tp_axis:
        return y
    if cfg.tp_sequence:
        return cc.sp_reduce_scatter(y, cfg.tp_axis, dim=1)
    return cc.tp_allreduce(y, cfg.tp_axis)


def _lora_bank(module: nn.Module, cfg: TransformerConfig, name: str,
               d_in: int, d_out: int) -> None:
    """Register one projection's delta bank, ``<name>_A`` (n, d_in, r)
    and ``<name>_B`` (n, r, d_out) with n = ``lora_adapters + 1``, zeros
    in ``cfg.dtype``: every id starts as the base model until its rows
    are written. Not part of the state dict (the weight bridge and the
    optimizers see the base parameters alone)."""
    n = cfg.lora_adapters + 1
    module.register_buffer(
        f"{name}_A", torch.zeros(n, d_in, cfg.lora_rank, dtype=cfg.dtype),
        persistent=False)
    module.register_buffer(
        f"{name}_B", torch.zeros(n, cfg.lora_rank, d_out, dtype=cfg.dtype),
        persistent=False)


# The LoRA sites whose first product a batched GEMM orders by the batch's
# size on an H100: the down site's 3072-long reduction (GPT-2's d_ff);
# the 768-long ones (qkv, proj, up) keep a request's bits at any batch
# size there (chip_smoke.py phase 23 checks both, and holds the engine
# to the one-shot generator bitwise).
LORA_ROW_SUM_SITES = frozenset({"down"})


def _lora_delta(module: nn.Module, name: str, x, adapter):
    """``x @ A[id] @ B[id]`` with per-request ids: ``x`` (B, C, d_in),
    ``adapter`` (B,) int; one gathered pair of ``bmm`` calls serves every
    adapter resident in the batch. At the sites of ``LORA_ROW_SUM_SITES`` a
    batched GEMM would give a request's delta other bits in an 8-slot
    engine step than in a one-request generator step, so there the first
    product is taken as f32 products summed by :func:`row_sum`, then
    rounded to the bank's dtype; the second sums only r terms and stays a
    ``bmm`` everywhere."""
    a = getattr(module, f"{name}_A").index_select(0, adapter)  # (B, d, r)
    b = getattr(module, f"{name}_B").index_select(0, adapter)  # (B, r, e)
    if name in LORA_ROW_SUM_SITES:
        prod = x.float()[:, :, None, :] * a.transpose(1, 2).float()[:, None]
        t = row_sum(prod.contiguous()).to(b.dtype)  # (B, C, r)
    else:
        t = torch.bmm(x.to(a.dtype), a)  # (B, C, r)
    return torch.bmm(t, b)


LORA_SITES = {"attn": ("qkv", "proj"), "mlp": ("up", "down")}


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        h, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
        # rows ordered (3, H, hd) like flax's qkv kernel (D, 3, H, hd)
        self.qkv = _projection(cfg, d, 3 * h * hd)
        self.proj = _projection(cfg, h * hd, d)
        if cfg.lora:
            _lora_bank(self, cfg, "qkv", d, 3 * h * hd)
            _lora_bank(self, cfg, "proj", h * hd, d)

    def forward(self, x, index=None, *, cache=None, block_tables=None,
                adapter=None):
        cfg = self.cfg
        x = _tp_enter(x, cfg)
        B, S, _ = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        qkv = _project(cfg, self.qkv, x, cfg.dtype)
        if adapter is not None:
            qkv = qkv + _lora_delta(self, "qkv", x, adapter)
        qkv = qkv.view(B, S, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, S, H, hd)
        if cfg.decode and cfg.paged:
            out = self._paged_decode_attend(q, k, v, index, cache,
                                            block_tables)
        elif cfg.decode:
            out = self._decode_attend(q, k, v, index, cache)
        elif cfg.resolve_attn_impl(S) == "flash":
            out = FA.flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = self._dense_attend(q, k, v)
        flat = out.reshape(B, S, h * hd)
        out = _project(cfg, self.proj, flat, cfg.dtype)
        if adapter is not None:
            out = out + _lora_delta(self, "proj", flat, adapter)
        return _tp_leave(out, cfg)  # after the row-parallel proj

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
        kernel-layout cache in place (``index_copy_`` at ``index +
        arange(C)``: the index stays on the device), then K5 reads it."""
        if index is None or cache is None:
            raise ValueError("the decode view needs the write index and "
                             "the cache")
        C = q.shape[1]
        index = DA.device_index(index, q.device)
        rows = index.to(torch.int64) + torch.arange(C, device=q.device)
        kT = k.transpose(1, 2)  # (B, H, C, hd)
        vT = v.transpose(1, 2)
        ks = vs = None
        if self.cfg.kv_dtype == "int8":
            k8, v8, k_sc, v_sc = self._quantized(kT, vT)
            cache["k"].index_copy_(2, rows, k8)
            cache["v"].index_copy_(2, rows, v8)
            cache["ks"].index_copy_(3, rows, k_sc)
            cache["vs"].index_copy_(3, rows, v_sc)
            ks, vs = cache["ks"], cache["vs"]
        else:
            cache["k"].index_copy_(2, rows, kT.to(cache["k"].dtype))
            cache["v"].index_copy_(2, rows, vT.to(cache["v"].dtype))
        return DA.decode_attention(q, cache["k"], cache["v"], index,
                                   key_scale=ks, value_scale=vs,
                                   split_keys=self.cfg.decode_split_keys)

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
            key_scale_pool=ks, value_scale_pool=vs, block_size=bs,
            split_keys=cfg.decode_split_keys)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.up = _projection(cfg, cfg.d_model, cfg.d_ff, bias=True)
        self.down = _projection(cfg, cfg.d_ff, cfg.d_model)
        if cfg.lora:
            _lora_bank(self, cfg, "up", cfg.d_model, cfg.d_ff)
            _lora_bank(self, cfg, "down", cfg.d_ff, cfg.d_model)

    def forward(self, x, adapter=None):
        cfg = self.cfg
        x = _tp_enter(x, cfg)
        y = _project(cfg, self.up, x, cfg.dtype)
        if adapter is not None:
            y = y + _lora_delta(self, "up", x, adapter)
        y = F.gelu(y, approximate="tanh")
        down_in = y
        y = _project(cfg, self.down, y, cfg.dtype)
        if adapter is not None:
            y = y + _lora_delta(self, "down", down_in, adapter)
        return _tp_leave(y, cfg)  # after the row-parallel down


class ExpertBank(nn.Module):
    """The f32 kernels of one MoE projection for every expert: ``weight``
    (E, d_in, d_out), the reference's ``_ExpertBank`` layout (the
    product's own; ``ops/quant.quantize_params`` folds it per expert)."""

    def __init__(self, e: int, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(e, d_in, d_out))

    def forward(self, x, dtype):
        return torch.bmm(x, self.weight.to(dtype))


class WeightQuantBank(nn.Module):
    """The weight-only quantised sibling of :class:`ExpertBank`
    (``cfg.weight_dtype``), the reference's ``_WeightQuantBank``: buffers
    ``qkernel`` (E, d_in[/2], d_out) and ``scale`` (E, d_out) f32, each
    expert's kernel through ``ops/quant.wq_bank_matmul``."""

    def __init__(self, e: int, d_in: int, d_out: int, weight_dtype: str):
        super().__init__()
        self.bits, rows, store = _quant_storage(d_in, weight_dtype)
        self.register_buffer("qkernel", torch.zeros(e, rows, d_out,
                                                    dtype=store))
        self.register_buffer("scale", torch.ones(e, d_out))

    def forward(self, x, dtype):
        return quant.wq_bank_matmul(x, self.qkernel, self.scale,
                                    bits=self.bits, dtype=dtype)


def router_logits(x, weight):
    """f32 router logits (T, E) of ``x`` (T, d) against ``weight`` (E, d),
    as f32 products summed by :func:`row_sum`: a token's logits do not
    depend on how many rows route with it (an 8-slot engine step against
    the solo generator), where one bit moves a gate and can move the
    argmax."""
    return row_sum((x.float()[:, None, :] * weight.float()[None])
                   .contiguous())


def moe_capacity(cfg: TransformerConfig, rows: int, tokens: int) -> int:
    """Seats an expert has in a call of ``rows`` x ``tokens`` tokens:
    ``cfg.moe_capacity`` for one token a row, else all of them (top-1: an
    expert cannot receive more, so the call is dropless)."""
    if cfg.moe_capacity is not None and tokens == 1:
        return cfg.moe_capacity
    return rows * tokens


class MoEMLP(nn.Module):
    """The routed top-1 MoE FFN (``cfg.moe_experts``), the reference's
    ``MoEMLP``: an f32 ``router`` (no bias) picks each token's expert by
    the argmax of its softmax gates; the token is copied into that
    expert's seat of an (E, C, d) buffer (``parallel/expert.route`` /
    ``dispatch``: seats fill in token order), the experts run as two
    ``bmm`` with the tanh GELU between, and the output row comes back
    times the gate cast to ``cfg.dtype`` (``combine``). ``C`` is
    ``cfg.moe_capacity`` for one token a row (decode) and every token
    otherwise (:func:`moe_capacity`); a token past capacity gets exactly
    zero from the FFN.

    ``moe_mask`` (rows of the call, bool) routes a row nowhere: no seat,
    no census entry (the engine's idle slots and prefill pads). A
    ``census`` list gets this layer's ``(load (E,), overflow (E,),
    overflow_tok (T,))``, int64 on the device (the reference's
    ``sow("moe_stats")``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e, d, ff = cfg.moe_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Linear(d, e, bias=False)
        if cfg.weight_dtype:
            self.w_in = WeightQuantBank(e, d, ff, cfg.weight_dtype)
            self.w_out = WeightQuantBank(e, ff, d, cfg.weight_dtype)
        else:
            self.w_in = ExpertBank(e, d, ff)
            self.w_out = ExpertBank(e, ff, d)

    def forward(self, x, moe_mask=None, census=None):
        cfg = self.cfg
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        capacity = moe_capacity(cfg, b, s)
        gates = torch.softmax(router_logits(xt, self.router.weight), dim=-1)
        r = EP.route(gates, 1, capacity, moe_mask)
        if census is not None:
            census.append((r.load, r.overflow, r.overflow_tok))
        xb = EP.dispatch(xt.to(cfg.dtype), r).view(cfg.moe_experts,
                                                     capacity, d)
        h = F.gelu(self.w_in(xb, cfg.dtype), approximate="tanh")
        out = self.w_out(h, cfg.dtype)
        y = EP.combine(out.reshape(-1, d), r, cfg.dtype)
        return y.reshape(b, s, d).to(x.dtype)


def moe_census_sum(census: list) -> tuple:
    """A forward's census, summed over its MoE layers: ``(load (E,),
    overflow (E,), overflow_tok (T,))``."""
    return tuple(torch.stack(parts).sum(dim=0) for parts in zip(*census))


class Block(nn.Module):
    """Pre-LN block: x + attn(LN(x)); x + mlp(LN(x))."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, cfg.decode)
        self.attn = MultiHeadAttention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, cfg.decode)
        self.mlp = MoEMLP(cfg) if cfg.moe else MLP(cfg)

    def forward(self, x, index=None, *, cache=None, block_tables=None,
                adapter=None, moe_mask=None, moe_census=None):
        cfg = self.attn.cfg
        h = self.ln1(x)
        if (cfg.remat_mode == "attention" and not cfg.decode
                and torch.is_grad_enabled()):
            # recompute the attention sub-layer in the backward
            x = x + checkpoint(self.attn, h, use_reentrant=False)
        else:
            x = x + self.attn(h, index, cache=cache,
                              block_tables=block_tables, adapter=adapter)
        if cfg.moe:
            return x + self.mlp(self.ln2(x), moe_mask, moe_census)
        return x + self.mlp(self.ln2(x), adapter)


class Transformer(nn.Module):
    """Tokens in, float32 logits out.

    ``forward(tokens, index=None, *, cache=None, block_tables=None,
    adapter=None)``: ``tokens`` (B, S) int; in decode mode ``index`` is
    the absolute position of ``tokens[:, 0]`` — for the contiguous view an
    int or a 0-d / (1,) integer tensor on the model's device (the
    captured one-shot loop advances it there), for the paged view a (B,)
    tensor (one position per request) — and ``cache`` is what
    :meth:`init_cache` / :meth:`init_pool` returned, updated in place.
    ``adapter`` ((B,) int, with ``cfg.lora_rank``) picks each request's
    row of the delta banks; None runs the base model. With
    ``cfg.moe_experts``, ``moe_mask`` ((B,) or (B, S) bool) keeps rows out
    of the routing and a ``moe_census`` list gets each MoE layer's census
    (:class:`MoEMLP`; :func:`moe_census_sum` adds them up).
    """

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)
        self.blocks = nn.ModuleList(Block(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, cfg.decode)
        if cfg.num_classes is None:
            self.lm_head = _projection(cfg, cfg.d_model, cfg.vocab_size)
        else:
            self.classifier = nn.Linear(cfg.d_model, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "Transformer":
        """Random weights from ``seed`` with the JAX package's
        initialisers: normal(0.02) for every kernel and embedding, zeros
        for biases, ones for LayerNorm scales, and flax's lecun-normal
        Dense default for a classifier. Drawn on the CPU with an explicit
        generator, so a seed gives the same weights on every device."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_"):
                p.fill_(1.0)
            elif name == "classifier.weight":
                p.copy_(lecun_normal(p.shape, p.shape[1], gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self

    def with_config(self, cfg: TransformerConfig) -> "Transformer":
        """A model under another config (the decode and paged views of a
        training model, or its first ``cfg.num_layers`` blocks: the
        speculative draft) that shares this one's parameter tensors. A
        LoRA view starts from zero delta banks of its own
        (:meth:`set_adapter_bank` fills them)."""
        with torch.device("meta"):
            view = Transformer(cfg)
        sd = self.state_dict()
        if cfg.num_layers < self.cfg.num_layers:
            sd = {k: t for k, t in sd.items()
                  if not k.startswith("blocks.")
                  or int(k.split(".")[1]) < cfg.num_layers}
        view.load_state_dict(sd, assign=True)
        for name, buf in view.adapter_bank().items():
            mod, leaf = name.rsplit(".", 1)
            setattr(view.get_submodule(mod), leaf,
                    torch.zeros(buf.shape, dtype=buf.dtype,
                                device=self.device))
        return view

    def adapter_bank(self) -> dict[str, torch.Tensor]:
        """The live delta banks, name -> buffer (``blocks.{i}.attn.qkv_A``
        ...): write new adapter weights into these tensors in place."""
        return {name: buf for name, buf in self.named_buffers()
                if name.endswith(("_A", "_B"))}

    def set_adapter_bank(self, bank) -> None:
        """Give this model its own copy of ``bank`` (name -> tensor or
        array, named as :meth:`adapter_bank` names them), on its device in
        ``cfg.dtype``."""
        for name, buf in self.adapter_bank().items():
            src = torch.as_tensor(bank[name])
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(f"adapter bank {name}: shape "
                                 f"{tuple(src.shape)}, the model's is "
                                 f"{tuple(buf.shape)}")
            mod, leaf = name.rsplit(".", 1)
            setattr(self.get_submodule(mod), leaf,
                    src.to(device=self.device, dtype=buf.dtype).clone())

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    def _apply(self, fn, *args, **kwargs):
        # every move (.to, .cuda, ...) goes through here: refuse a head dim
        # the card's kernels do not take before any weight moves
        check_placement(self.cfg, fn(torch.empty(0, device=self.device))
                        .device)
        return super()._apply(fn, *args, **kwargs)

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

    def forward(self, tokens, index=None, *, cache=None, block_tables=None,
                adapter=None, moe_mask=None, moe_census=None,
                return_hidden: bool = False):
        cfg = self.cfg
        if cfg.decode and index is None:
            raise ValueError("cfg.decode=True requires the position index")
        if adapter is not None and not cfg.lora:
            raise ValueError("adapter ids given but cfg.lora_rank is None")
        dt = cfg.dtype
        if cfg.tp_axis:
            x = vocab_parallel_embed(tokens, self.tok_emb.weight,
                                     cfg.tp_axis, dt,
                                     sequence_parallel=cfg.tp_sequence)
        else:
            x = self.tok_emb(tokens).to(dt)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        if cfg.tp_sequence:  # this rank's slice of the sequence
            ax = resolve_axis(cfg.tp_axis)
            positions = positions.chunk(ax.size)[ax.index]
        if cfg.decode and cfg.paged:
            # the engine passes one position per request (B,)
            index = torch.as_tensor(index, device=tokens.device)
            positions = positions[None, :] + index.reshape(-1, 1)
        elif cfg.decode:
            # the one-shot generator: one position, kept on the device
            index = DA.device_index(index, tokens.device)
            positions = positions + index.to(torch.int64)
        x = x + self.pos_emb(positions).to(dt)
        remat_blocks = (cfg.remat_mode == "block" and not cfg.decode
                        and torch.is_grad_enabled())
        for i, blk in enumerate(self.blocks):
            if remat_blocks:
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x, index, cache=None if cache is None else cache[i],
                        block_tables=block_tables, adapter=adapter,
                        moe_mask=moe_mask, moe_census=moe_census)
        x = self.ln_f(x)
        if cfg.tp_sequence:  # the whole sequence into the head
            x = cc.sp_all_gather(x, cfg.tp_axis, dim=1)
        if return_hidden:  # the fused-CE loss applies the head itself
            return x
        if cfg.num_classes is not None:  # [CLS] pooling
            return _linear(x[:, 0], self.classifier.weight,
                           self.classifier.bias, dtype=torch.float32)
        return _project(cfg, self.lm_head, x, torch.float32, head=True)

    def quantize(self, weight_dtype: str) -> "Transformer":
        """A serving copy of this (f32-weight) model with its projections
        (and expert banks) stored as ``weight_dtype`` ("int8", "int4",
        "fp8"; the MoE router stays f32) through
        ``ops/quant.quantize_params``, on this model's device; the other
        parameters are shared."""
        if self.cfg.weight_dtype is not None:
            raise ValueError(f"this model is quantised already "
                             f"({self.cfg.weight_dtype})")
        cfg = dataclasses.replace(self.cfg, weight_dtype=weight_dtype)
        sd = quant.quantize_params(self.state_dict(),
                                   bits=quant.WQ_BITS[weight_dtype])
        with torch.device("meta"):
            view = Transformer(cfg)
        view.load_state_dict(sd, assign=True)
        return view


def vocab_parallel_embed(tokens, weight, axis: str, dtype, *,
                         sequence_parallel: bool = False):
    """Megatron's parallel embedding: ``weight`` is this rank's (V / tp,
    D) slice of the token table along ``axis``; each rank looks up the
    tokens that fall in its slice (zeros elsewhere), casts to ``dtype``
    and ``tp_allreduce`` sums the shards, so each shard's rows get exactly
    their own cotangents. With ``sequence_parallel`` the sum is a
    reduce-scatter along S: this rank keeps its slice of the sequence."""
    v_local = weight.shape[0]
    local = tokens.long() - resolve_axis(axis).index * v_local
    ok = (local >= 0) & (local < v_local)
    e = (weight[local.clamp(0, v_local - 1)]
         * ok[..., None].to(weight.dtype)).to(dtype)
    if sequence_parallel:
        return cc.sp_reduce_scatter(e, axis, dim=1)
    return cc.tp_allreduce(e, axis)


def vocab_parallel_next_token_loss(x, weight, tokens, axis: str, *,
                                   sum_dx: bool = True):
    """Megatron's vocab-parallel next-token cross-entropy over full
    logits of this rank's vocabulary shard: ``x`` (B, S, D) post-LN,
    ``weight`` (V / tp, D) the shard of the LM head, ``tokens`` (B, S)
    global ids. The max, the sum of exponentials and the target logit
    are assembled over ``axis`` (the max without a gradient, exact for a
    log-sum-exp); ``x`` passes ``tp_identity`` so that its gradient sums
    every shard's part, unless ``sum_dx`` is False (sequence parallelism:
    ``x``'s own gather sums it). The loss is the mean over B * (S - 1)
    targets."""
    v_local = weight.shape[0]
    if sum_dx:
        x = cc.tp_identity(x, axis)
    z = _linear(x[:, :-1], weight, dtype=torch.float32)  # (B, S-1, V/tp)
    targets = tokens[:, 1:].long()
    m = cc.pmax(z.detach().amax(dim=-1), axis)
    sumexp = cc.tp_allreduce(torch.exp(z - m[..., None]).sum(dim=-1), axis)
    lse = torch.log(sumexp) + m
    local = targets - resolve_axis(axis).index * v_local
    ok = (local >= 0) & (local < v_local)
    z_t = z.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    z_t = cc.tp_allreduce(torch.where(ok, z_t, torch.zeros_like(z_t)), axis)
    return (lse - z_t).mean()


def make_lm_loss_fn(model: Transformer, *, fused_ce="auto",
                    ce_chunk: int | None = None):
    """Next-token LM loss: ``loss_fn(module, batch) -> (loss, metrics)``.

    ``module`` is the Transformer that holds the parameters (the JAX
    package passes its param tree in that place); ``batch["tokens"]`` is
    (B, S) int. The loss is the mean over the B * (S - 1) shifted targets,
    and ``metrics`` is ``{"perplexity": exp(loss)}``, both 0-d tensors.

    ``fused_ce`` ("auto" | True | False, ``ops.fused_ce.resolve_fused_ce``
    on ``model``'s device) routes the head through the chunked fused
    cross-entropy: the trunk stops at the final LayerNorm
    (``return_hidden``) and no (B, S, V) tensor is ever live. Otherwise
    the logits come out in f32 and go through ``log_softmax``.

    A tensor-parallel ``model`` (``cfg.tp_axis``) holds a vocabulary shard
    of the LM head: the fused loss then runs vocab-parallel
    (``axis=cfg.tp_axis``) and the full-logits one becomes
    :func:`vocab_parallel_next_token_loss`. Under sequence parallelism
    (``cfg.tp_sequence``) the hidden states' gather sums their gradient,
    so the loss leaves it to it.
    """
    from distributed_tensorflow_guide_tpu_torch.ops.fused_ce import (
        fused_next_token_loss,
        resolve_fused_ce,
    )

    if model.cfg.weight_dtype is not None:
        raise ValueError(
            f"weight_dtype={model.cfg.weight_dtype!r} is a serving config: "
            "train the f32 model and quantise it for serving")
    use_fused = resolve_fused_ce(fused_ce, vocab_size=model.cfg.vocab_size,
                                 platform=model.device.type)
    axis = model.cfg.tp_axis
    sum_dx = not model.cfg.tp_sequence

    def loss_fn(module, batch):
        tokens = batch["tokens"]
        if use_fused:
            hidden = module(tokens, return_hidden=True)
            loss = fused_next_token_loss(hidden, module.lm_head.weight.t(),
                                         tokens, chunk=ce_chunk, axis=axis,
                                         sum_dx=sum_dx)
        elif axis:
            hidden = module(tokens, return_hidden=True)
            loss = vocab_parallel_next_token_loss(
                hidden, module.lm_head.weight, tokens, axis, sum_dx=sum_dx)
        else:
            logits = module(tokens)  # (B, S, V) float32
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            targets = tokens[:, 1:].long()
            ll = logp.gather(-1, targets[..., None])[..., 0]
            loss = -ll.mean()
        return loss, {"perplexity": torch.exp(loss)}

    return loss_fn


def make_cls_loss_fn(model: Transformer):
    """Sequence classification (GLUE-style): ``loss_fn(module, batch) ->
    (loss, {"accuracy"})`` over ``batch["tokens"]`` (B, S) and
    ``batch["label"]`` (B,)."""

    def loss_fn(module, batch):
        logits = module(batch["tokens"])
        return (cross_entropy_loss(logits, batch["label"]),
                {"accuracy": accuracy(logits, batch["label"])})

    return loss_fn
