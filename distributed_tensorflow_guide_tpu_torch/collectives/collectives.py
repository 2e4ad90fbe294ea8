"""The communication layer: every collective the port issues, in one
traceable place.

Each op takes an axis of the port's mesh (``core/mesh.py``), by name,
resolved against the mesh passed as ``mesh=`` or the one entered with
``with mesh:`` (or as the ``AxisGroup`` a name resolves to), and runs on
that axis's process group. A tuple of names is one joint axis (the
reductions over ``("data", "expert")`` of expert parallelism, recorded
as ``psum[data,expert]``). Inside an active
:func:`trace_comm` every call records its op, its axis, the payload bytes
this rank hands it and the bytes it puts on the wire. The JAX package's
trace counts traced call sites (a site inside a ``lax.scan`` counts once);
this trace counts **executed** calls, so a site that runs ``n`` times
counts ``n`` times.

Differentiable: ``ppermute`` (its gradient runs the inverse permutation)
and ``all_to_all`` (its gradient runs the inverse exchange), which ring
attention's blockwise path and Ulysses differentiate through, and
Megatron's conjugate pair of tensor parallelism, ``tp_allreduce`` (``g``:
a psum forward, the identity backward) and ``tp_identity`` (``f``: the
identity forward, a psum backward). The other reductions and the gathers
return values without a gradient.

One card, several ranks: NCCL refuses two ranks on one device, so such a
world runs over gloo, which all-reduces CUDA tensors but has no CUDA
send/recv or all-to-all. For a gloo group holding CUDA tensors, the ops
other than the all-reductions copy the message through pinned host memory
and back (logged once); nothing else leaves the card. Over NCCL the same
call is a device-to-device transfer: which one runs is a property of the
group the caller built, not a fallback.

Megatron sequence parallelism adds a second conjugate pair,
``sp_all_gather`` (all-gather forward, reduce-scatter of the sum backward)
and ``sp_reduce_scatter`` (reduce-scatter of the sum forward, all-gather
backward): the same bytes on the wire as ``tp_identity`` and
``tp_allreduce``, with the stream between them cut along a dimension.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from collections import defaultdict
from typing import Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    AxisGroup,
    Mesh,
    resolve_axis,
)

log = logging.getLogger(__name__)

# the active traces, innermost last; process-wide (not a context variable)
# because autograd runs a CUDA backward, and its collectives, on a thread
# of its own
_TRACES: list["CommTrace"] = []
_STAGED_NOTED = False
# the transfers this module has in flight: its torch.distributed calls and
# the host staging copies of a gloo group holding CUDA tensors (the
# program auditor's census tells them from a collective that bypasses this
# module, and from a host sync of the program's own)
_ISSUING = [0]


def issuing() -> bool:
    """Whether this module is inside a ``torch.distributed`` call or a
    staging copy of one."""
    return _ISSUING[0] > 0


@contextlib.contextmanager
def _issue():
    _ISSUING[0] += 1
    try:
        yield
    finally:
        _ISSUING[0] -= 1


@dataclasses.dataclass
class CommTrace:
    """Executed collective calls, payload bytes and wire bytes, keyed
    ``"op[axis]"``. Payload is what this rank hands the op; wire is what it
    sends: 2·P·(n−1)/n for an all-reduce (ring reduce-scatter + all-gather,
    ``benchmarks/common.py`` ``dp_allreduce_bytes``); P·(n−1)/n for a
    reduce-scatter (one pass of the ring, ``lax.psum_scatter``'s) and for
    an all-to-all; P·(n−1) for an all-gather; P per destination for a
    permutation."""

    calls: dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    bytes: dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    wire: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    def record(self, op: str, axis: str, payload: int,
               wire: float) -> None:
        key = f"{op}[{axis}]"
        self.calls[key] += 1
        self.bytes[key] += payload
        self.wire[key] += wire

    def total_calls(self) -> int:
        return sum(self.calls.values())


@contextlib.contextmanager
def trace_comm():
    """Record every collective executed in this process while the context
    is open (nested traces: the innermost records)."""
    rec = CommTrace()
    _TRACES.append(rec)
    try:
        yield rec
    finally:
        _TRACES.remove(rec)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _record(op: str, ax: AxisGroup, tree, wire_factor: float) -> None:
    if _TRACES:
        p = _nbytes(tree)
        _TRACES[-1].record(op, ax.name, p, p * wire_factor)


def record_event(op: str, axis: "str | tuple[str, ...]", tree=None
                 ) -> None:
    """A named event that is not a collective, recorded in the active
    ``trace_comm`` under ``op[axis]`` (a tuple axis joined as a joint
    axis's name): one call, the payload bytes of ``tree``'s tensors (the
    JAX package's count), no wire bytes, since nothing is sent. For a
    decision that changes the communication or compute profile without a
    collective of its own, so that a trace shows it."""
    if _TRACES:
        name = axis if isinstance(axis, str) else ",".join(axis)
        _TRACES[-1].record(op, name, _nbytes(tree), 0.0)


def axis_size(axis: str, *, mesh: Mesh | None = None) -> int:
    """Size of a mesh axis (NCCL's world size of the axis's group)."""
    return resolve_axis(axis, mesh).size


def _staged(ax: AxisGroup, x: torch.Tensor) -> bool:
    """True for a CUDA tensor on a gloo group: the message goes through
    pinned host memory."""
    global _STAGED_NOTED
    if not x.is_cuda or dist.get_backend(ax.group) != "gloo":
        return False
    if not _STAGED_NOTED:
        _STAGED_NOTED = True
        log.info("gloo group holding CUDA tensors: send/recv and all-to-all "
                 "messages are copied through pinned host memory")
    return True


def _to_host(x: torch.Tensor) -> torch.Tensor:
    with _issue():
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
    return buf


def _to_device(x: torch.Tensor, device) -> torch.Tensor:
    with _issue():
        return x.to(device)


# ---- reductions and gathers -------------------------------------------------


def _rebuild(node, leaves):
    """``node``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if isinstance(node, torch.Tensor):
        return next(leaves)
    if isinstance(node, dict):
        return {k: _rebuild(v, leaves) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, leaves) for v in node)
    return node


def _all_reduce(tree, ax: AxisGroup, op, mean: bool):
    """One all-reduce per (dtype, device) group of leaves, over one flat
    buffer; returns the tree's structure with new tensors."""
    leaves = [t.detach() for t in _leaves(tree)]
    if ax.size > 1:
        kinds: dict[tuple, list[int]] = defaultdict(list)
        for i, t in enumerate(leaves):
            kinds[(t.dtype, t.device)].append(i)
        for idx in kinds.values():
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            with _issue():
                dist.all_reduce(flat, op=op, group=ax.group)
            if mean:
                flat /= ax.size
            parts = flat.split([leaves[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                leaves[i] = part.view_as(leaves[i])
    return _rebuild(tree, iter(leaves))


def _reduce_wire(n: int) -> float:
    return 2.0 * (n - 1) / n


def psum(x, axis: "str | tuple[str, ...]", *,
         mesh: Mesh | None = None):
    """All-reduce sum over ``axis`` of a tensor or a dict / list of them
    (one flat all-reduce per dtype)."""
    ax = resolve_axis(axis, mesh)
    _record("psum", ax, x, _reduce_wire(ax.size))
    return _all_reduce(x, ax, dist.ReduceOp.SUM, mean=False)


def pmean(x, axis: "str | tuple[str, ...]", *,
          mesh: Mesh | None = None):
    """All-reduce mean: the gradient average of data parallelism."""
    ax = resolve_axis(axis, mesh)
    _record("pmean", ax, x, _reduce_wire(ax.size))
    return _all_reduce(x, ax, dist.ReduceOp.SUM, mean=True)


def pmax(x, axis: "str | tuple[str, ...]", *,
         mesh: Mesh | None = None):
    """All-reduce max."""
    ax = resolve_axis(axis, mesh)
    _record("pmax", ax, x, _reduce_wire(ax.size))
    return _all_reduce(x, ax, dist.ReduceOp.MAX, mean=False)


def _all_gather(x: torch.Tensor, ax: AxisGroup, *, tiled: bool,
                gather_axis: int) -> torch.Tensor:
    """One ``all_gather_into_tensor`` of ``x`` over ``ax`` (records
    nothing): every rank's ``x`` stacked on a new dim ``gather_axis``, or
    concatenated along it with ``tiled``."""
    n = ax.size
    # stacked: every rank sends x with a leading dim of 1, so that the
    # concatenation along dim 0 is the stack (gloo takes only that form)
    send = (x.detach().movedim(gather_axis, 0) if tiled
            else x.detach().unsqueeze(0)).contiguous()
    if n == 1:
        return send.movedim(0, gather_axis).contiguous()
    staged = _staged(ax, send)
    if staged:
        send = _to_host(send)
    out = torch.empty((n * send.shape[0], *send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    with _issue():
        dist.all_gather_into_tensor(out, send, group=ax.group)
    if staged:
        out = _to_device(out, x.device)
    # (n * d, ...) or (n, ...), moved to gather_axis
    return out.movedim(0, gather_axis).contiguous()


def all_gather(x: torch.Tensor, axis: str, *, tiled: bool = False,
               gather_axis: int = 0, mesh: Mesh | None = None):
    """Every rank's ``x`` along ``axis``: stacked on a new dim
    ``gather_axis``, or concatenated along it with ``tiled=True``. One
    ``all_gather_into_tensor``."""
    ax = resolve_axis(axis, mesh)
    _record("all_gather", ax, x, float(ax.size - 1))
    return _all_gather(x, ax, tiled=tiled, gather_axis=gather_axis)


def _reduce_scatter(x: torch.Tensor, ax: AxisGroup,
                    scatter_axis: int) -> torch.Tensor:
    """The sum over ``ax`` of which this rank keeps its slice: one
    ``reduce_scatter_tensor`` over ``x`` with ``scatter_axis`` moved
    first."""
    n = ax.size
    if x.shape[scatter_axis] % n:
        raise ValueError(f"dim {scatter_axis} of {tuple(x.shape)} does not "
                         f"divide by the axis size {n}")
    if n == 1:
        return x.detach().clone()
    send = x.detach().movedim(scatter_axis, 0).contiguous()
    staged = _staged(ax, send)
    if staged:
        send = _to_host(send)
    out = torch.empty((send.shape[0] // n, *send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    with _issue():
        dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM,
                                   group=ax.group)
    if staged:
        out = _to_device(out, x.device)
    return out.movedim(0, scatter_axis).contiguous()


def reduce_scatter(x: torch.Tensor, axis: str, *, scatter_axis: int = 0,
                   mesh: Mesh | None = None):
    """The sum over ``axis``, of which this rank keeps its ``1/n`` slice
    along ``scatter_axis`` (``lax.psum_scatter``, tiled): one
    ``reduce_scatter_tensor``, one pass of the ring, P·(n−1)/n on the
    wire."""
    ax = resolve_axis(axis, mesh)
    out = _reduce_scatter(x, ax, scatter_axis)
    _record("reduce_scatter", ax, x, (ax.size - 1) / ax.size)
    return out


# ---- permutation and all-to-all ---------------------------------------------


def _ppermute(x: torch.Tensor, ax: AxisGroup, perm) -> torch.Tensor:
    me, n = ax.index, ax.size
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"perm {perm} is not a partial permutation of "
                         f"range({n})")
    to = [d for s, d in perm if s == me and d != me]
    frm = [s for s, d in perm if d == me and s != me]
    _record("ppermute", ax, x, float(len(to)))
    out = None
    if to or frm:
        send = x.contiguous()
        staged = _staged(ax, send)
        if staged:
            send = _to_host(send)
        ops = [dist.P2POp(dist.isend, send, ax.ranks[d], group=ax.group)
               for d in to]
        if frm:
            out = torch.empty_like(send)
            ops.append(dist.P2POp(dist.irecv, out, ax.ranks[frm[0]],
                                  group=ax.group))
        with _issue():
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if out is not None and staged:
            out = _to_device(out, x.device)
    if out is not None:
        return out
    if (me, me) in perm:  # a rank that keeps its own value
        return x.clone()
    return torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _ppermute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g.contiguous(), ctx.ax, inverse), None, None


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[tuple[int, int]],
             *, mesh: Mesh | None = None) -> torch.Tensor:
    """Point-to-point permutation over ``axis``: the rank at index ``s``
    sends ``x`` to index ``d`` for every ``(s, d)`` in ``perm``; a rank
    that receives nothing gets zeros. Sends and receives of one call are
    posted together (``batch_isend_irecv``), so a ring cannot deadlock."""
    ax = resolve_axis(axis, mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, ax, perm)
    return _ppermute(x.detach(), ax, perm)


def ring_shift(x: torch.Tensor, axis: str, *, shift: int = 1,
               mesh: Mesh | None = None) -> torch.Tensor:
    """Rotate ``x`` ``shift`` steps around the axis ring: index i sends to
    (i + shift) mod n."""
    n = axis_size(axis, mesh=mesh)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)],
                    mesh=mesh)


def _all_to_all(x: torch.Tensor, ax: AxisGroup, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = ax.size
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"divide by the axis size {n}")
    _record("all_to_all", ax, x, (n - 1) / n)
    if n == 1:
        return x.clone()
    chunks = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    staged = _staged(ax, chunks)
    if staged:
        chunks = _to_host(chunks)
    out = torch.empty_like(chunks)
    with _issue():
        dist.all_to_all_single(out, chunks, group=ax.group)
    if staged:
        out = _to_device(out, x.device)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.args = (ax, split_axis, concat_axis)
        return _all_to_all(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.args
        return (_all_to_all(g.contiguous(), ax, concat_axis, split_axis),
                None, None, None)


def all_to_all(x: torch.Tensor, axis: str, *, split_axis: int,
               concat_axis: int, mesh: Mesh | None = None) -> torch.Tensor:
    """All-to-all resharding (``lax.all_to_all``, tiled): ``x`` is cut
    into n chunks along ``split_axis``, chunk j goes to index j, and the
    chunks received are concatenated along ``concat_axis`` in source order.
    The Ulysses sequence <-> heads exchange."""
    ax = resolve_axis(axis, mesh)
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, ax, split_axis, concat_axis)
    return _all_to_all(x.detach(), ax, split_axis, concat_axis)


# ---- Megatron's tensor-parallel conjugate pair (f / g) ----------------------
#
# Inside a tensor-parallel block every rank of the ``model`` axis holds the
# same (replicated) residual stream and a shard of the weights. ``f`` at a
# sub-layer's input is the identity forward and sums the shards' partial
# cotangents backward; ``g`` after the row-parallel product sums the
# shards' partial outputs forward and passes the cotangent through
# unchanged. With the pair around each sub-layer the sharded weights get
# their own gradients and every replicated tensor (LayerNorm, embeddings,
# the residual stream) gets the full one, on every rank.


class _TPAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax, dist.ReduceOp.SUM, mean=False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the wire traffic of f happens here, in the backward
        _record("psum_bwd", ctx.ax, g, _reduce_wire(ctx.ax.size))
        return _all_reduce(g.contiguous(), ctx.ax, dist.ReduceOp.SUM,
                           mean=False), None


def tp_allreduce(x: torch.Tensor, axis: "str | tuple[str, ...]", *,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """Megatron's ``g``: psum over ``axis`` forward, identity backward.
    Outside tensor parallelism it is the psum of a sum of per-rank partial
    contributions to a value every rank then uses alike (a global-mean
    loss): the backward hands each rank its own partial's cotangent."""
    ax = resolve_axis(axis, mesh)
    _record("psum", ax, x, _reduce_wire(ax.size))
    if ax.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _TPAllReduce.apply(x, ax)
    return _all_reduce(x, ax, dist.ReduceOp.SUM, mean=False)


def tp_identity(x: torch.Tensor, axis: str, *,
                mesh: Mesh | None = None) -> torch.Tensor:
    """Megatron's ``f``: identity forward, psum over ``axis`` backward
    (recorded as ``psum_bwd`` when the backward runs)."""
    ax = resolve_axis(axis, mesh)
    if ax.size > 1 and torch.is_grad_enabled() and x.requires_grad:
        return _TPIdentity.apply(x, ax)
    return x


# ---- Megatron sequence parallelism's pair -----------------------------------
#
# Under sequence parallelism the residual stream between the sub-layers is
# cut along the sequence over ``model``. The column-parallel product needs
# the whole sequence: ``sp_all_gather`` gathers it forward and, backward,
# sums the shards' partial cotangents and hands each rank its slice (a
# reduce-scatter: ``f``'s psum cut in half). After the row-parallel
# product ``sp_reduce_scatter`` sums the partial outputs and keeps this
# rank's slice forward (``g``'s psum cut in half) and gathers the
# cotangent backward. Each pair moves what one all-reduce of the full
# activation moves: P·(n−1)/n forward and as much backward.


class _SPAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, tiled=True, gather_axis=dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.ax.size
        _record("reduce_scatter_bwd", ctx.ax, g, (n - 1) / n)
        return _reduce_scatter(g, ctx.ax, ctx.dim), None, None


class _SPReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _reduce_scatter(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        _record("all_gather_bwd", ctx.ax, g, float(ctx.ax.size - 1))
        return _all_gather(g, ctx.ax, tiled=True,
                           gather_axis=ctx.dim), None, None


def sp_all_gather(x: torch.Tensor, axis: str, *, dim: int = 1,
                  mesh: Mesh | None = None) -> torch.Tensor:
    """Sequence parallelism's gather: this rank's slice of ``x`` along
    ``dim`` -> the whole of it forward; the sum of the cotangents, cut
    back to this rank's slice, backward (recorded as
    ``reduce_scatter_bwd``)."""
    ax = resolve_axis(axis, mesh)
    _record("all_gather", ax, x, float(ax.size - 1))
    if ax.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SPAllGather.apply(x, ax, dim)
    return _all_gather(x, ax, tiled=True, gather_axis=dim)


def sp_reduce_scatter(x: torch.Tensor, axis: str, *, dim: int = 1,
                      mesh: Mesh | None = None) -> torch.Tensor:
    """Sequence parallelism's scatter: the sum of every rank's ``x``, of
    which this rank keeps its slice along ``dim``, forward; the gathered
    cotangent backward (recorded as ``all_gather_bwd``)."""
    ax = resolve_axis(axis, mesh)
    n = ax.size
    _record("reduce_scatter", ax, x, (n - 1) / n)
    if n == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SPReduceScatter.apply(x, ax, dim)
    return _reduce_scatter(x, ax, dim)
