"""Tensor parallelism over the ``model`` mesh axis: judged config 3,
BERT-base "under ParameterServerStrategy -> pjit param-sharded".

The JAX package lays the parameters out by logical axis names and lets
GSPMD place every collective (``DEFAULT_RULES``: heads, mlp and vocab on
``model``, batch on ``data``). A rank of this package is a process, so the
layout and the collectives are stated here:

* every parameter those rules put on ``model`` is cut into ``tp`` shards
  (:func:`shard_state_dict`): ``qkv`` and ``proj`` by head, ``up`` (and its
  bias) and ``down`` by d_ff, the token embedding and ``lm_head`` by
  vocabulary. The rest (LayerNorms, ``pos_emb``, BERT's ``classifier``)
  is replicated;
* each rank runs the ``tp_local`` module on its shards
  (:func:`local_config`); Megatron's ``f``/``g`` pair around each
  sub-layer (``models/transformer.py``) makes its values and gradients
  exact, the token embedding is looked up vocab-parallel, and the LM loss
  is taken vocab-parallel (``ops/fused_ce.py`` with ``axis``, or the full
  logits of the shard);
* :class:`TensorParallel`'s steps average the gradients and the metrics
  over ``data``, as ``DataParallel``'s do. A replicated parameter already
  has its full gradient on every ``model`` rank (through ``f``), so no
  other reduction is added.

Megatron sequence parallelism (``rules=MEGATRON_SP_RULES``, Korthikanti
et al. 2022): between the TP sub-layers the residual stream, and with it
LayerNorm, the residual adds and the positions, is cut along the sequence
over ``model`` (``TransformerConfig.tp_sequence``). An all-gather along S
(reduce-scatter backward) replaces ``f`` before ``qkv`` and ``up``, a
reduce-scatter (all-gather backward) replaces ``g`` after ``proj`` and
``down``: the same bytes on the wire as the all-reduces they replace,
with the stream's activation memory divided by tp. Attention still sees
the whole sequence (the JAX rules' ``seq_inner``). The LayerNorms and
``pos_emb`` see only their slice's rows, so their gradients are partial:
the step sums them over ``model`` (one ``psum``), where GSPMD inserts
that sum in the JAX package.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)

# logical axis name -> mesh axis, the JAX package's rules; only these two
# are taken. Under both, heads, mlp and vocab go to "model" and batch to
# "data"; MEGATRON_SP_RULES also maps the residual stream's "seq" there.
DEFAULT_RULES = (
    ("batch", "data"),
    ("seq", None),
    ("seq_inner", None),
    ("embed", None),
    ("qkv", None),
    ("mlp", "model"),
    ("heads", "model"),
    ("kv", None),
    ("vocab", "model"),
)
MEGATRON_SP_RULES = tuple(
    ("seq", "model") if name == "seq" else (name, axis)
    for name, axis in DEFAULT_RULES
)

# the dim each sharded parameter is cut along, by the end of its name
# (``blocks.3.mlp.up.weight``, ``chunks.0.1.attn.qkv.weight``); "heads"
# is qkv's (3, H, hd) rows, cut by head within each of q, k and v
_SPLITS = {
    "tok_emb.weight": 0,
    "lm_head.weight": 0,
    "attn.qkv.weight": "heads",
    "attn.proj.weight": 1,
    "mlp.up.weight": 0,
    "mlp.up.bias": 0,
    "mlp.down.weight": 1,
}


def split_dim(name: str):
    """How the parameter ``name`` is cut over ``model``: a dim, "heads",
    or None for a replicated one."""
    for suffix, dim in _SPLITS.items():
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def shard_tensor(name: str, t: torch.Tensor, tp: int, index: int
                 ) -> torch.Tensor:
    """Shard ``index`` of ``tp`` of the full parameter ``name`` (a new
    contiguous tensor; a replicated parameter comes back as it is)."""
    dim = split_dim(name)
    if dim is None or tp == 1:
        return t
    if dim == "heads":  # (3 * H * hd, D) rows ordered (3, H, hd)
        return t.reshape(3, tp, -1, t.shape[-1])[:, index].reshape(
            -1, t.shape[-1]).contiguous()
    if t.shape[dim] % tp:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not "
                         f"divide by tp={tp}")
    return t.chunk(tp, dim=dim)[index].contiguous()


def merge_tensor(name: str, parts: list[torch.Tensor]) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the full parameter from its
    shards in ``model`` order."""
    dim = split_dim(name)
    if dim is None or len(parts) == 1:
        return parts[0]
    if dim == "heads":
        d = parts[0].shape[-1]
        return torch.stack([p.reshape(3, -1, d) for p in parts],
                           dim=1).reshape(-1, d)
    return torch.cat(parts, dim=dim)


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp: int,
                     index: int) -> dict[str, torch.Tensor]:
    """Shard ``index`` of every parameter of a full state dict."""
    return {n: shard_tensor(n, t, tp, index) for n, t in sd.items()}


def local_config(cfg: TransformerConfig, tp: int, *,
                 sequence_parallel: bool = False) -> TransformerConfig:
    """The config of one rank's module: ``cfg.tp_local`` (local heads and
    ff, global head dim, the f/g pair on ``model``) with the vocabulary
    shard's ``vocab_size`` V / tp, and ``tp_sequence`` under sequence
    parallelism."""
    if cfg.vocab_size % tp:
        raise ValueError(f"vocab_size {cfg.vocab_size} must divide by tp "
                         f"{tp} (vocab-parallel embedding and head)")
    return dataclasses.replace(cfg.tp_local(tp, "model"),
                               vocab_size=cfg.vocab_size // tp,
                               tp_sequence=sequence_parallel)


def gather_state_dict(local: Mapping[str, torch.Tensor], mesh: Mesh
                      ) -> dict[str, torch.Tensor]:
    """The full tensors of a sharded state dict (parameters or their
    gradients), on every rank of ``model``: each sharded entry is
    all-gathered and merged, a replicated one kept as it is. Every rank
    of the axis calls it."""
    return {n: (t if split_dim(n) is None else merge_tensor(
        n, list(cc.all_gather(t, "model", mesh=mesh).unbind(0))))
        for n, t in local.items()}


class TensorParallel(DataParallel):
    """Tensor-parallel train and eval steps over ``mesh``'s ``model``
    axis, data-parallel over its ``data`` axis.

    ``rules``: :data:`DEFAULT_RULES` or :data:`MEGATRON_SP_RULES` (the
    sequence-parallel stream; the sequence must divide by tp).
    ``device=None`` is this rank's CUDA card (raises without one);
    ``device="cpu"`` runs the plain versions of the kernels. Build the
    rank's module with :meth:`shard`; each rank's batch is the share of
    its ``data`` index, the same on every rank of a ``model`` group.
    """

    def __init__(self, mesh: Mesh, rules=DEFAULT_RULES, *, device=None):
        rules = tuple(tuple(r) for r in rules)
        if rules not in (DEFAULT_RULES, MEGATRON_SP_RULES):
            raise ValueError("rules must be DEFAULT_RULES or "
                             "MEGATRON_SP_RULES")
        super().__init__(mesh, "data", device=device)
        self.rules = rules
        self.sequence_parallel = rules == MEGATRON_SP_RULES
        ax = mesh.axis("model")
        self.tp, self.index = ax.size, ax.index

    def shard_state_dict(self, full: Mapping[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
        """This rank's shards of a full state dict (or of its
        gradients)."""
        return shard_state_dict(full, self.tp, self.index)

    def shard(self, model: Transformer) -> Transformer:
        """This rank's module: the ``tp_local`` Transformer holding its
        shards of ``model``'s parameters, on the step's device."""
        cfg = local_config(model.cfg, self.tp,
                           sequence_parallel=self.sequence_parallel)
        with torch.device("meta"):
            local = Transformer(cfg)
        local.load_state_dict(self.shard_state_dict(
            {n: t.detach().clone() for n, t in model.state_dict().items()}),
            assign=True)
        return local.to(self.device)

    def gather(self, local: Mapping[str, torch.Tensor]
               ) -> dict[str, torch.Tensor]:
        """The full state dict (or gradients) from every rank's shards."""
        return gather_state_dict(local, self.mesh)

    def complete_grads(self, grads: dict) -> dict:
        """Under sequence parallelism the replicated parameters'
        gradients (the LayerNorms', ``pos_emb``'s) hold only this slice of
        the sequence's part: one ``psum`` over ``model`` makes them
        whole. Call inside ``with mesh:``."""
        if self.sequence_parallel and self.tp > 1:
            grads.update(cc.psum({n: g for n, g in grads.items()
                                  if split_dim(n) is None}, "model"))
        return grads

    def value_and_grad(self, loss_fn, module, batch):
        """((loss, metrics), gradients) of this rank's batch, whole on the
        ``model`` group and not yet averaged over ``data``."""
        with self.mesh:
            out, grads = value_and_grad(loss_fn, module, batch)
            return out, self.complete_grads(grads)

    def _context(self):
        return self.mesh  # the f/g pair resolves "model" against it

    def make_train_step(self, loss_fn, *, accum_steps: int = 1,
                        steps_per_call: int | None = None,
                        stacked_batch: bool = False):
        """``(state, batch) -> (state, {"loss", **metrics})``: the
        tensor-parallel forward and backward on this rank's shards, the
        gradients and metrics averaged over ``data``, one update.
        ``steps_per_call`` / ``stacked_batch``: ``DataParallel``'s k steps
        a call (one CUDA graph where no axis runs over gloo); the metrics
        are the last inner step's, as in the reference."""
        return super().make_train_step(
            loss_fn, accum_steps=accum_steps, steps_per_call=steps_per_call,
            stacked_batch=stacked_batch)
