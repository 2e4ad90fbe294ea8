"""Expert parallelism (MoE) over the ``expert`` mesh axis: the JAX
package's ``parallel/expert.py`` in PyTorch.

Experts are sharded whole over ``expert``, and the tokens travel to them:
each rank routes its own tokens, one ``all_to_all`` over ``expert`` sends
every expert's capacity rows to the rank that holds it, the rank runs its
experts as two batched products, and a second ``all_to_all`` brings the
outputs back. Tokens are sharded jointly over ``data`` and ``expert``
(``MoEConfig.token_axes``); the Switch aux statistics are averaged over
both, so every rank reports the global value.

Routing is written as index algebra, not as the reference's one-hot
(T, E, C) einsums (:func:`route`): each token's seat in its expert's
buffer comes from an exclusive cumsum in token order, the kept rows are
copied into a flat (E·C + 1, d) buffer whose last row is a sink for
dropped and masked tokens (:func:`dispatch`), and the combine gathers the
same rows back times ``gate · keep`` (:func:`combine`). For top-1 the
values are the one-hot algebra's bit for bit: exact row copies in, one
nonzero product out. The one-hot form stays as the plain version
(:func:`route_onehot`, ``MoEConfig.dispatch="onehot"``), which tests and
the card's comparison run; at GPT-2 widths and a 4096-token batch its
(T, E, C) tensors hold 134 MB a layer each and its two einsums cost
2·T·E·C·d FLOPs, where the index form copies T rows.

Everything here has static shapes and no host sync (no ``nonzero``, no
boolean-mask indexing, no ``.item()``), so a serving step that routes can
be captured as a CUDA graph (``models/transformer.MoEMLP``).

Gradients follow the reference's intent: the loss is the global mean, so
a rank's autograd gradient is its partial contribution (the global
reductions in the forward are ``collectives.tp_allreduce``: a psum
forward, the cotangent passed through backward), the replicated router's
gradient is summed over the token axes and the expert stacks' over
``data`` (their ``expert`` contributions arrived through the backward
``all_to_all``). Under ``shard_map(check_vma=False)`` the JAX package's
``psum`` transposes to a psum, so its gradients come out multiplied by the
number of token shards (ROADMAP Queue 3); the port's are the global
loss's own, equal to one process's on the union batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh

__all__ = ["MoEConfig", "Route", "route", "route_onehot", "dispatch",
           "combine", "init_moe_params", "moe_ffn", "ExpertParallel"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int          # global expert count, divisible by axis size
    top_k: int = 2
    capacity_factor: float = 1.25
    # "switch": fixed capacity, tokens past capacity_factor's headroom
    # drop; "dropless": capacity = the shard's token count, which admits
    # every token (a token picks an expert at most once)
    router: str = "switch"
    axis: str = "expert"
    # the other mesh axis that shards tokens (None: expert alone)
    data_axis: str | None = "data"
    dtype: torch.dtype = torch.float32
    # "index" (the path) or "onehot" (the reference's algebra, the plain
    # version the tests and the card's comparison run)
    dispatch: str = "index"

    def __post_init__(self):
        if self.router not in ("switch", "dropless"):
            raise ValueError(
                f"router must be 'switch' or 'dropless', got {self.router!r}")
        if self.dispatch not in ("index", "onehot"):
            raise ValueError(
                f"dispatch must be 'index' or 'onehot', got "
                f"{self.dispatch!r}")

    @property
    def token_axes(self) -> tuple[str, ...]:
        return (self.data_axis, self.axis) if self.data_axis else (self.axis,)


# ---- routing ----------------------------------------------------------------


@dataclasses.dataclass
class Route:
    """Where each token's choices go. ``rows`` (k, T) int64: the row of
    choice r of token t in the flat (E·C + 1)-row buffer, ``E·C`` (the
    sink) where it was dropped or masked; ``weights`` (k, T): its gate
    times keep, in the gates' dtype. The census, int64: ``load`` (E,)
    seated choices, ``overflow`` (E,) routed choices past capacity,
    ``overflow_tok`` (T,) dropped choices of each token."""

    rows: torch.Tensor
    weights: torch.Tensor
    load: torch.Tensor
    overflow: torch.Tensor
    overflow_tok: torch.Tensor
    capacity: int

    @property
    def sink(self) -> int:
        return self.load.shape[0] * self.capacity


def route(gates: torch.Tensor, top_k: int, capacity: int,
          mask: torch.Tensor | None = None) -> Route:
    """Fixed-capacity top-k assignment as index algebra: choice r of each
    token goes to its r-th best expert at the next free seat (seats fill
    in token order, carried across rounds), or to the sink past
    ``capacity``. ``gates`` (T, E); ``mask`` (T,) bool routes a token
    nowhere (no seat, no census entry)."""
    t, e = gates.shape
    dev = gates.device
    live = (None if mask is None
            else mask.reshape(t).to(torch.int64)[:, None])
    fill = torch.zeros(e, dtype=torch.int64, device=dev)
    load = torch.zeros(e, dtype=torch.int64, device=dev)
    overflow = torch.zeros(e, dtype=torch.int64, device=dev)
    of_tok = torch.zeros(t, dtype=torch.int64, device=dev)
    rows, weights = [], []
    g = gates
    experts = torch.arange(e, device=dev)
    for _ in range(top_k):
        idx = g.argmax(dim=1)
        # (T, E) int64; not F.one_hot, which checks its indices' range
        # with two host syncs on the CPU under autograd
        onehot = (idx[:, None] == experts).to(torch.int64)
        routed = onehot if live is None else onehot * live
        # exclusive cumsum: the seat of each token in its expert
        pos = routed.cumsum(dim=0) - routed + fill[None, :]
        seat = pos.gather(1, idx[:, None])[:, 0]
        keep = (routed.sum(dim=1) > 0) & (seat < capacity)
        rows.append(torch.where(keep, idx * capacity + seat,
                                torch.full_like(seat, e * capacity)))
        weights.append(gates.gather(1, idx[:, None])[:, 0]
                       * keep.to(gates.dtype))
        kept = routed * keep[:, None].to(torch.int64)
        fill = fill + kept.sum(dim=0)
        load = load + kept.sum(dim=0)
        dropped = routed - kept
        overflow = overflow + dropped.sum(dim=0)
        of_tok = of_tok + dropped.sum(dim=1)
        g = g * (1 - onehot).to(g.dtype)  # mask the chosen expert
    return Route(torch.stack(rows), torch.stack(weights), load, overflow,
                 of_tok, capacity)


def route_onehot(gates: torch.Tensor, top_k: int, capacity: int,
                 mask: torch.Tensor | None = None):
    """The reference's one-hot algebra (``_topk_dispatch``; ``MoEMLP``'s
    ``moe_mask``), the plain version of :func:`route`: ``dispatch`` (T, E,
    C) in {0, 1} and ``combine`` (T, E, C) gate-weighted, in the gates'
    dtype."""
    t, e = gates.shape
    dispatch_ = gates.new_zeros((t, e, capacity))
    combine_ = gates.new_zeros((t, e, capacity))
    fill = gates.new_zeros(e)
    g = gates
    for _ in range(top_k):
        onehot = F.one_hot(g.argmax(dim=1), e).to(gates.dtype)
        routed = (onehot if mask is None
                  else onehot * mask.reshape(t).to(gates.dtype)[:, None])
        pos = routed.cumsum(dim=0) - routed + fill[None, :]
        pos_i = pos.to(torch.int64)
        keep = routed * (pos_i < capacity).to(gates.dtype)
        slot = keep[:, :, None] * F.one_hot(
            pos_i.clamp(max=capacity), capacity + 1)[..., :capacity].to(
                gates.dtype)
        gate_val = (gates * onehot).sum(dim=1)
        dispatch_ = dispatch_ + slot
        combine_ = combine_ + slot * gate_val[:, None, None]
        fill = fill + keep.sum(dim=0)
        g = g * (1.0 - onehot)
    return dispatch_, combine_


def dispatch(x: torch.Tensor, r: Route) -> torch.Tensor:
    """The (E·C, d) expert buffer: each kept choice's token row copied to
    its seat, zeros elsewhere (dropped and masked choices land in the sink
    row, which is cut off). Differentiable in ``x``."""
    k = r.rows.shape[0]
    src = x if k == 1 else x.repeat(k, 1)
    buf = x.new_zeros((r.sink + 1, x.shape[1]))
    return buf.index_copy(0, r.rows.reshape(-1), src)[:r.sink]


def combine(out: torch.Tensor, r: Route, weight_dtype: torch.dtype
            ) -> torch.Tensor:
    """(T, d): each token's sum over its choices of its expert's output
    row times ``gate · keep`` cast to ``weight_dtype`` (the reference's
    ``combine.astype(cfg.dtype)``), products and sum in float32, rounded
    once to the product's dtype (a dropped choice adds exact zeros)."""
    flat = torch.cat([out, out.new_zeros((1, out.shape[1]))])
    y = None
    for rows, w in zip(r.rows, r.weights):
        part = (flat.index_select(0, rows).float()
                * w.to(weight_dtype).float()[:, None])
        y = part if y is None else y + part
    return y.to(torch.promote_types(out.dtype, weight_dtype))


# ---- the expert-parallel layer ----------------------------------------------


def init_moe_params(cfg: MoEConfig, generator: torch.Generator) -> dict:
    """Router (d, E) and the expert stacks (E, d, ff) / (E, ff, d), normal
    at 1/√d_model (router, w_in) and 1/√d_ff (w_out), cast to
    ``cfg.dtype``, as the reference draws them (with torch's generator);
    the leading expert axis shards over ``expert``."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, fan):
        return (torch.randn(shape, generator=generator)
                / math.sqrt(fan)).to(cfg.dtype)

    return {"router": normal((d, e), d), "w_in": normal((e, d, ff), d),
            "w_out": normal((e, ff, d), ff)}


def capacity_of(cfg: MoEConfig, t_local: int) -> int:
    """Seats an expert a shard: the shard's token count for the dropless
    router, ``max(1, ceil(top_k · T · capacity_factor / E))`` for
    Switch."""
    if cfg.router == "dropless":
        return t_local
    return max(1, math.ceil(cfg.top_k * t_local * cfg.capacity_factor
                            / cfg.num_experts))


def _pmean_partial(x: torch.Tensor, axes) -> torch.Tensor:
    """The mean over ``axes`` of a value every rank then uses alike; its
    gradient is this rank's share (``tp_allreduce`` / n)."""
    return cc.tp_allreduce(x, axes) / cc.axis_size(axes)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """One MoE FFN layer on this rank's tokens, inside ``with mesh:``.

    ``params``: router (d, E), w_in (E_local, d, ff), w_out (E_local, ff,
    d), this rank's expert shard; ``x`` (T_local, d). Returns ``(y
    (T_local, d), aux)``: aux holds the Switch ``load_balance`` and
    ``z_loss`` (global, the same on every rank) and this rank's census,
    ``expert_load`` (E,) seated choices and ``dropped``."""
    n_dev = cc.axis_size(cfg.axis)
    e_global = cfg.num_experts
    e_local = params["w_in"].shape[0]
    if e_local * n_dev != e_global:
        raise ValueError(
            f"{e_global} experts over {n_dev} devices needs "
            f"{e_global // n_dev} local, got {e_local}")
    t_local, d = x.shape
    capacity = capacity_of(cfg, t_local)

    # the router always in float32: routing is precision-sensitive
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1)
    xd = x.to(cfg.dtype)
    if cfg.dispatch == "onehot":
        disp, comb = route_onehot(gates, cfg.top_k, capacity)
        expert_in = torch.einsum("tec,td->ecd", disp.to(cfg.dtype), xd)
        load = disp.sum(dim=(0, 2)).to(torch.int64)
    else:
        r = route(gates, cfg.top_k, capacity)
        expert_in = dispatch(xd, r).view(e_global, capacity, d)
        load = r.load
    dropped = cfg.top_k * t_local - load.sum()

    # Switch aux losses, averaged over every token-sharding axis
    frac_tokens = cc.pmean(load.to(gates.dtype) / t_local, cfg.token_axes)
    frac_probs = _pmean_partial(gates.mean(dim=0), cfg.token_axes)
    load_balance = e_global * (frac_tokens * frac_probs).sum() / cfg.top_k
    z_loss = _pmean_partial(
        (torch.logsumexp(logits, dim=-1) ** 2).mean(), cfg.token_axes)

    # (E, C, d) -> (E_local, n·C, d): my experts' rows from every rank
    expert_in = cc.all_to_all(expert_in, cfg.axis, split_axis=0,
                              concat_axis=1)
    w_in, w_out = params["w_in"], params["w_out"]
    dt = torch.promote_types(cfg.dtype, w_in.dtype)
    h = F.gelu(torch.bmm(expert_in.to(dt), w_in.to(dt)),
               approximate="tanh")
    out = torch.bmm(h, w_out.to(dt))
    # back: (E_local, n·C, d) -> (E, C, d)
    out = cc.all_to_all(out, cfg.axis, split_axis=1, concat_axis=0)
    if cfg.dispatch == "onehot":
        y = torch.einsum("tec,ecd->td", comb.to(cfg.dtype).to(out.dtype),
                         out)
    else:
        y = combine(out.reshape(e_global * capacity, d), r, cfg.dtype)
    return y.to(x.dtype), {"load_balance": load_balance, "z_loss": z_loss,
                           "expert_load": load, "dropped": dropped}


class ExpertParallel:
    """One MoE layer sharded over ``expert`` (the EP sibling of
    ``parallel/tensor.py``): ``shard_params`` gives this rank its experts,
    ``token_shard`` its rows of a global batch, ``apply`` the forward and
    ``make_train_step`` an SGD step on an MSE toy objective, which runs
    the whole path (routing, both ``all_to_all``\\ s, the expert products,
    the gradient reductions). Every rank calls each method together.
    ``device=None`` is the CUDA card (raises without one)."""

    def __init__(self, mesh: Mesh, cfg: MoEConfig, *, device=None):
        n = mesh.axis(cfg.axis).size
        if cfg.num_experts % n:
            raise ValueError(
                f"num_experts {cfg.num_experts} not divisible by "
                f"{cfg.axis} axis size {n}")
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)

    def expert_slice(self) -> slice:
        ax = self.mesh.axis(self.cfg.axis)
        per = self.cfg.num_experts // ax.size
        return slice(ax.index * per, (ax.index + 1) * per)

    def shard_params(self, params: dict) -> dict:
        """This rank's share of the full params: the router whole, its
        experts' rows of the stacks, on the device."""
        sl = self.expert_slice()
        return {"router": params["router"].to(self.device),
                "w_in": params["w_in"][sl].to(self.device),
                "w_out": params["w_out"][sl].to(self.device)}

    def token_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (T, ...) array, sharded jointly
        over the token axes."""
        ax = self.mesh.axis(self.cfg.token_axes)
        per = x.shape[0] // ax.size
        return torch.as_tensor(x)[ax.index * per:(ax.index + 1) * per].to(
            self.device)

    def apply(self, params: dict, x: torch.Tensor):
        """This rank's (y, aux) for its token shard ``x``."""
        with self.mesh:
            return moe_ffn(params, x, self.cfg)

    def make_train_step(self, lr: float = 0.1, *, aux_weight: float = 1e-2):
        """``step(params, x, y_target) -> (params, metrics)``: SGD on the
        global mean squared error plus ``aux_weight`` x (load balance + z
        loss)."""
        cfg = self.cfg
        axes = cfg.token_axes

        def step(params, x, y_target):
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            with self.mesh:
                y, aux = moe_ffn(p, x, cfg)
                se = ((y - y_target) ** 2).sum()
                n = cc.psum(torch.tensor(float(y.numel()), device=y.device),
                            axes)
                loss = (cc.tp_allreduce(se, axes) / n
                        + aux_weight * (aux["load_balance"]
                                        + aux["z_loss"]))
                grads = dict(zip(p, torch.autograd.grad(loss,
                                                        list(p.values()))))
                grads["router"] = cc.psum(grads["router"], axes)
                if cfg.data_axis:
                    grads.update(cc.psum({k: grads[k] for k in
                                          ("w_in", "w_out")},
                                         cfg.data_axis))
            new = {k: (p[k] - lr * grads[k].to(p[k].dtype)).detach()
                   for k in p}
            return new, {"loss": loss.detach(),
                         "load_balance": aux["load_balance"].detach(),
                         "z_loss": aux["z_loss"].detach()}

        return step
