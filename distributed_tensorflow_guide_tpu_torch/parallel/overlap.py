"""Communication overlap: the bucketed data-parallel all-reduce and the
FSDP gather/scatter markers.

* **Bucketed backward all-reduce** (PyTorch DDP's gradient bucketing, Li
  et al., VLDB'20): the parameters are cut into byte-budgeted buckets
  (:func:`bucket_assignment`, in ``named_parameters`` order) and each
  bucket gets a boundary (:func:`bucket_sync`): the parameters unchanged
  forward, one ``pmean`` of the bucket's flat gradient buffer backward.
  A bucket's all-reduce is issued from its leaves' gradient hooks as soon
  as autograd has produced the last of its gradients, mid-backward,
  instead of one monolithic ``pmean`` after it. It is issued with
  ``async_op=True`` and the bucket goes into the step's own ``pending``
  list; the step waits on every bucket of that list
  (:func:`wait_buckets`) before the optimizer reads the gradients, which
  is DDP's recipe: under NCCL a synchronous all-reduce
  inside the backward would order the compute stream behind it and hide
  nothing. An all-reduce is elementwise, so a two-rank sum is the same
  bits in any bucketing: the bucketed gradients equal the monolithic ones
  bitwise at two ranks (at more, gloo's ring may add a buffer's elements
  in an order that depends on its chunking).

  ``compress="int8"`` sends each bucket in int8 (``ops/quant.py``'s
  ``int8_pmean`` transform): the bucket's amax goes out first in a scalar
  ``pmax`` (synchronous, 4 bytes), then the int8 values in one async
  ``psum``; :func:`wait_buckets` turns the sum back into the mean. The
  trace records ``pmax[data]`` and ``psum[data]``, so the wire is 1 byte
  an element plus 4 bytes of scale a bucket, each at the ring's
  2·(n−1)/n.

* **FSDP's markers** (ZeRO-3, Rajbhandari et al., SC'20): a sharded leaf
  passes :func:`gather_shard` (all-gather of the full parameter forward,
  reduce-scatter of the MEAN gradient backward, so the gradient comes
  back in shard layout), a replicated one :func:`replicated_grad_sync`
  (identity forward, ``pmean`` backward). :func:`gather_params` applies
  them leaf by leaf, each gather synchronous.

Each marker records its collective in the active ``CommTrace`` under the
JAX package's names: ``all_gather[data]``, ``reduce_scatter[data]``,
``pmean[data]``.

The JAX module's ``apply_xla_overlap_flags`` sets libtpu flags that let
XLA's scheduler run collectives async; under NCCL the async work handles
above take that place, so it has no counterpart here. The bucket budget
is a tuned value (``ops/autotune.py``'s ``dp_bucket`` entry, keyed on the
gradients' MiB, the world and the wire dtype): :func:`resolve_bucket_bytes`
takes the entry, else :data:`DEFAULT_BUCKET_BYTES` (the JAX package's
tested default; always on the CPU). It is swept only with a caller's
``measure`` that times the caller's own step. The axis's first rank
decides it and broadcasts it: a budget that differed between ranks would
give different bucket layouts, and the all-reduces would hang or sum the
wrong buffers.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    AxisGroup,
    Mesh,
    resolve_axis,
)
from distributed_tensorflow_guide_tpu_torch.ops import autotune
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    LossFn,
)

DEFAULT_BUCKET_BYTES = autotune.DEFAULT_BUCKET_BYTES


# ---- knob resolution ---------------------------------------------------------


def axis_backend(ax: AxisGroup) -> str | None:
    """The backend of an axis's process group (None for an axis of one
    rank, which has none)."""
    return None if ax.group is None else dist.get_backend(ax.group)


def _resolve_nccl_auto(setting, knob: str, backend: str | None) -> bool:
    """``"auto"|True|False`` (and on/off spellings) -> bool; ``auto`` is
    on only where the axis's group runs over NCCL (the JAX package's "TPU
    only"): under gloo or on the CPU the off path stays today's."""
    if isinstance(setting, bool):
        return setting
    if setting is None:
        return False
    s = str(setting).lower()
    if s in ("on", "true", "1"):
        return True
    if s in ("off", "false", "0"):
        return False
    if s != "auto":
        raise ValueError(
            f"{knob} must be 'auto', on/True or off/False, got {setting!r}")
    return backend == "nccl"


def resolve_overlap(setting, *, backend: str | None = None) -> bool:
    """DataParallel's ``overlap`` knob (bucketed backward all-reduce);
    ``auto`` is on under NCCL only."""
    return _resolve_nccl_auto(setting, "overlap", backend)


def resolve_prefetch(setting, *, backend: str | None = None) -> bool:
    """FSDP's ``prefetch`` knob; ``auto`` is on under NCCL only. Both
    values run the same schedule (``parallel/fsdp.py``)."""
    return _resolve_nccl_auto(setting, "fsdp prefetch", backend)


def resolve_compress(setting) -> str | None:
    """The gradient-compression knob: ``None``/"off"/"none" -> None (the
    full-precision wire), "int8" -> "int8" (``ops/quant.int8_pmean``'s
    transform). Never resolved from the backend: it changes the numerics,
    so it is an explicit opt-in."""
    if setting is None:
        return None
    s = str(setting).lower()
    if s in ("off", "none", ""):
        return None
    if s == "int8":
        return "int8"
    raise ValueError(
        f"compress must be None/'off' or 'int8', got {setting!r}")


# ---- bucketed DP all-reduce --------------------------------------------------


def resolve_bucket_bytes(params: Mapping[str, torch.Tensor], axis: str, *,
                         mesh: Mesh | None = None,
                         compress: str | None = None,
                         measure=None) -> int:
    """The bucket budget of a bucketed backward over ``params`` on
    ``axis``: the ``dp_bucket`` entry for (their bytes, the axis size, the
    wire dtype: int8 when compressed, else the first parameter's) through
    ``autotune.ensure_tuned_online``, which sweeps only with ``measure``
    (``measure(bucket_bytes) -> seconds a step``, run on every rank of
    the axis in the same order), else :data:`DEFAULT_BUCKET_BYTES`. The
    axis's first rank decides and broadcasts; only it writes the table.
    Every rank of the axis must call it."""
    ax = resolve_axis(axis, mesh)
    leaves = list(params.values())
    dtype = (torch.int8 if compress == "int8"
             else leaves[0].dtype if leaves else torch.float32)
    device = leaves[0].device if leaves else torch.device("cpu")
    return autotune.ensure_tuned_online(
        autotune.BUCKET_KERNEL, measure=measure, device=device,
        group=ax.group,
        param_bytes=sum(t.numel() * t.element_size() for t in leaves),
        world=ax.size, dtype=dtype)


def bucket_assignment(leaves: Sequence[torch.Tensor], bucket_bytes: int
                      ) -> list[list[int]]:
    """Partition leaf indices into contiguous byte-budgeted buckets, in
    order. Every index appears once; a leaf larger than the budget gets a
    bucket of its own rather than being split."""
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, leaf in enumerate(leaves):
        nb = leaf.numel() * leaf.element_size()
        if cur and cur_bytes + nb > bucket_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        groups.append(cur)
    return groups


class _Bucket:
    """One bucket of one backward: a hook on each leaf copies its gradient
    into the bucket's flat buffer, and the last of them issues the
    buffer's all-reduce (async)."""

    def __init__(self, leaves: Sequence[torch.Tensor], ax: AxisGroup,
                 compress: str | None = None):
        self.ax = ax
        self.compress = compress
        self.sizes = [x.numel() for x in leaves]
        self.left = len(leaves)
        self.flat = None
        self.work = None
        self.q = self.scale = None
        self.handles = [x.register_hook(self._hook(k))
                        for k, x in enumerate(leaves)]

    def _hook(self, k: int):
        start, n = sum(self.sizes[:k]), self.sizes[k]

        def hook(g):
            if self.flat is None:
                self.flat = g.new_empty(sum(self.sizes))
            part = self.flat[start:start + n]
            part.copy_(g.reshape(-1))
            self.left -= 1
            if self.left == 0:
                self._issue()
            return part.view_as(g)

        return hook

    def _issue(self) -> None:
        """The bucket's all-reduce, async: the f32 buffer, or (int8) the
        shared scale first, then the int8 values."""
        buf = self.flat
        if self.compress == "int8":
            from distributed_tensorflow_guide_tpu_torch.ops import quant

            (self.q,), self.scale = quant.int8_encode([self.flat], self.ax)
            buf = self.q
            cc._record("psum", self.ax, buf, cc._reduce_wire(self.ax.size))
        else:
            cc._record("pmean", self.ax, buf, cc._reduce_wire(self.ax.size))
        if self.ax.size > 1:
            with cc._issue():
                self.work = dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                                            group=self.ax.group,
                                            async_op=True)

    def finish(self) -> None:
        """Wait on the all-reduce; the buffer then holds the mean."""
        if self.work is not None:
            self.work.wait()
        if self.q is not None:
            from distributed_tensorflow_guide_tpu_torch.ops import quant

            self.flat.copy_(quant.int8_decode(self.q, self.scale,
                                              self.ax.size, self.flat.dtype))
        elif self.work is not None:
            self.flat /= self.ax.size

    def remove_hooks(self) -> None:
        for h in self.handles:
            h.remove()


def bucket_sync(leaves: Sequence[torch.Tensor], axis: str, *,
                pending: list, mesh: Mesh | None = None,
                compress: str | None = None) -> None:
    """The DDP bucket boundary over one bucket's leaves (leaf tensors of
    one dtype), which are used as they are: in the next backward, one
    all-reduce of the bucket's flat gradient buffer, issued async as soon
    as the last of its gradients is ready. The bucket is appended to
    ``pending``; the gradients the backward returns are its mean only
    after ``wait_buckets(pending)``.

    The all-reduce is issued from a hook on each leaf, which autograd
    runs as soon as that leaf's gradient is ready. An
    ``autograd.Function`` applied before the forward would not do: its
    node is older than every node of the forward, and autograd runs the
    newest ready node first, so it would run after all of the
    backward's compute."""
    ax = resolve_axis(axis, mesh)
    for x in leaves:
        if not (x.is_leaf and x.requires_grad):
            raise ValueError("bucket_sync takes leaf tensors that require "
                             "grad (the module's parameters)")
    pending.append(_Bucket(leaves, ax, compress))


def wait_buckets(pending: list) -> int:
    """After the backward: remove each bucket's hooks, wait on its
    all-reduce and divide it by the axis size, emptying the list. The
    gradients the bucketed backward returned are then the ``pmean``.
    Returns the number of buckets waited on."""
    n = len(pending)
    while pending:
        b = pending.pop(0)
        b.remove_hooks()
        if b.left:
            raise RuntimeError("a bucket is still waiting for "
                               f"{b.left} gradients: wait after the "
                               "backward")
        b.finish()
    return n


def drop_buckets(pending: list) -> None:
    """Remove the hooks of every bucket left in ``pending`` and forget
    them, waiting on nothing: the clean-up of a step whose forward or
    backward raised (a no-op after :func:`wait_buckets`)."""
    while pending:
        pending.pop(0).remove_hooks()


def pmean_buckets(params: Mapping[str, torch.Tensor], axis: str,
                  bucket_bytes: int, *, pending: list,
                  mesh: Mesh | None = None,
                  compress: str | None = None) -> None:
    """:func:`bucket_sync` over each bucket of :func:`bucket_assignment`
    of ``params`` (leaf tensors): their next backward's gradients come
    out ``pmean``-ed bucket by bucket (after ``wait_buckets(pending)``).
    A bucket holds one dtype: a change of dtype closes it."""
    names = list(params)
    start = 0
    for end in range(1, len(names) + 1):
        if (end < len(names)
                and params[names[end]].dtype == params[names[start]].dtype):
            continue
        run = names[start:end]
        for group in bucket_assignment([params[n] for n in run],
                                       bucket_bytes):
            bucket_sync([params[run[i]] for i in group], axis,
                        pending=pending, mesh=mesh, compress=compress)
        start = end


class _LossCall(torch.nn.Module):
    """A module whose forward is ``loss_fn(module, batch)``, so that
    ``functional_call`` can run the loss on substituted parameters."""

    def __init__(self, module: torch.nn.Module, loss_fn: LossFn):
        super().__init__()
        self.module = module
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.module, batch)


def call_with_params(loss_fn: LossFn, module: torch.nn.Module,
                     params: Mapping[str, torch.Tensor], batch):
    """``loss_fn(module, batch)`` with ``module``'s parameters replaced by
    ``params`` (same names) for the call: ``torch.func.functional_call``
    around the loss."""
    return torch.func.functional_call(
        _LossCall(module, loss_fn),
        {f"module.{n}": t for n, t in params.items()}, (batch,))


def bucketed_loss_fn(loss_fn: LossFn, axis: str,
                     bucket_bytes: int | None = None, *, pending: list,
                     mesh: Mesh | None = None,
                     compress: str | None = None) -> LossFn:
    """``loss_fn`` with the module's parameters bucketed: the gradients of
    the result are already ``pmean``-ed over ``axis`` once
    ``wait_buckets(pending)`` has run (the caller must not ``pmean`` them
    again). Give each step a ``pending`` list of its own and call
    :func:`drop_buckets` on it if the step raises, so that nothing is
    left for the next step. ``bucket_bytes=None`` is
    :func:`resolve_bucket_bytes` at the first call (every rank of the axis
    makes it); ``compress="int8"`` sends the buckets in int8."""
    bb = bucket_bytes

    def wrapped(module, batch):
        nonlocal bb
        params = {n: p for n, p in module.named_parameters()
                  if p.requires_grad}
        if bb is None:
            bb = resolve_bucket_bytes(params, axis, mesh=mesh,
                                      compress=compress)
        pmean_buckets(params, axis, bb, pending=pending, mesh=mesh,
                      compress=compress)
        return loss_fn(module, batch)

    return wrapped


# ---- FSDP's gather/scatter markers -------------------------------------------


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return cc._all_gather(x, ax, tiled=True, gather_axis=dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.ax.size
        g = cc.reduce_scatter(g, ctx.ax, scatter_axis=ctx.dim)
        return g / n, None, None


def gather_shard(x: torch.Tensor, axis: str, dim: int, *,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """ZeRO-3's pair for one sharded leaf: all-gather the full parameter
    along ``dim`` forward; reduce-scatter the gradient and divide by the
    axis size backward, so that it comes back as this rank's shard of
    the mean."""
    ax = resolve_axis(axis, mesh)
    cc._record("all_gather", ax, x, float(ax.size - 1))
    return _GatherShard.apply(x, ax, dim)


class _ReplicatedGradSync(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return cc.pmean(g.contiguous(), ctx.ax), None


def replicated_grad_sync(x: torch.Tensor, axis: str, *,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """The replicated leaf's marker: identity forward, ``pmean`` of its
    gradient backward."""
    return _ReplicatedGradSync.apply(x, resolve_axis(axis, mesh))


def sharded_dim(spec: Sequence, axis: str) -> int | None:
    """The dim a spec (one entry per dim: an axis name, a tuple of them,
    or None) cuts over ``axis``, or None."""
    for i, names in enumerate(tuple(spec)):
        if names is None:
            continue
        if axis in (names if isinstance(names, tuple) else (names,)):
            return i
    return None


def gather_params(shards: Mapping[str, torch.Tensor],
                  specs: Mapping[str, Sequence], axis: str, *,
                  mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
    """Full parameters from FSDP shards, leaf by leaf, with ZeRO-3's
    backward attached: a sharded leaf (its spec cuts a dim over ``axis``)
    passes :func:`gather_shard`, a replicated one
    :func:`replicated_grad_sync`. One collective per leaf."""
    out = {}
    for name, x in shards.items():
        dim = sharded_dim(specs[name], axis)
        out[name] = (replicated_grad_sync(x, axis, mesh=mesh) if dim is None
                     else gather_shard(x, axis, dim, mesh=mesh))
    return out
