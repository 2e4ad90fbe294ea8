"""Two-tier multi-slice training: dense DP inside a slice, an infrequent
outer parameter sync across slices.

The JAX package's ``parallel/multislice.py`` (DiLoCo, Douillard et al.
2023: the bandwidth economics of DOWNPOUR, see ``async_ps.LocalSGD``).
The network between slices is far slower than the one inside a slice, so
the dense per-step gradient all-reduce stays inside the slice and the
slices meet once every ``sync_period`` steps with a parameter *delta*:

* **inner tier**: each slice runs ``sync_period`` synchronous DP steps,
  the gradient averaged over the within-slice ``data`` axis only, then a
  local optimizer update;
* **outer tier**: the slices average the round's delta ``anchor -
  params`` over the ``dcn`` axis (the only collective that crosses
  slices) and apply it through a Nesterov outer optimizer; the float
  inner-optimizer state is averaged alongside, so every slice enters the
  next round with the same state.

With ``sync_period=1``, ``outer_lr=1`` and ``outer_momentum=0`` the round
is plain sync DP split into a two-level reduction.

Here a rank is a process holding its own replica (``TrainState``), so
the state carries no leading world axis. :func:`two_tier_mesh` names the
slice index as the mesh axis ``dcn`` in front of the five axes of
``core/mesh.py``, slices being contiguous blocks of ranks; each axis is a
process group, gloo on the CPU and where ranks share a card (NCCL across
hosts waits for a machine with a card per rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    mesh_over,
    num_slices,
    world_and_rank,
)
from distributed_tensorflow_guide_tpu_torch.parallel.async_ps import (
    _float_moments,
)
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    to_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    value_and_grad,
)

DCN_AXIS = "dcn"

LossFn = Callable[[torch.nn.Module, Any], tuple[torch.Tensor, dict]]


def two_tier_mesh(spec: MeshSpec | None = None, *,
                  n_slices: int | None = None) -> Mesh:
    """This rank's ``(dcn, data, model, pipe, context, expert)`` mesh: the
    leading ``dcn`` axis indexes slices (contiguous blocks of ranks, the
    layout ``train/elastic_world.py`` launches), ``spec`` describes the
    mesh inside one slice and is resolved against ``world / n_slices``.
    ``n_slices`` defaults to :func:`~..core.mesh.num_slices`. Every rank
    must call it."""
    world, _ = world_and_rank()
    if n_slices is None:
        n_slices = num_slices()
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if world % n_slices:
        raise ValueError(
            f"{world} ranks do not split into {n_slices} slices")
    sizes = {DCN_AXIS: n_slices,
             **(spec or MeshSpec()).resolve(world // n_slices)}
    return mesh_over((DCN_AXIS, *AXES), sizes)


@dataclasses.dataclass
class TwoTierState:
    """The carried state of one outer round: the inner ``TrainState``
    and the outer optimizer's momentum ({parameter name: tensor} over the
    float parameters). A checkpoint saves and restores it like any
    state."""

    inner: Any
    outer_momentum: dict


class MultiSliceLocalSGD:
    """DiLoCo-style two-tier strategy over a :func:`two_tier_mesh`.

    One call of the train step is one outer round: ``sync_period`` inner
    sync-DP steps (the gradient averaged over ``data``), then the round's
    parameter delta averaged over ``dcn`` and applied through the
    Nesterov outer optimizer::

        m      <- outer_momentum * m + delta_mean
        params <- anchor - outer_lr * (delta_mean + outer_momentum * m)

    and the float inner-optimizer state averaged over ``dcn``.
    ``outer="off"`` runs no collective over ``dcn`` at all (the slices
    train apart: a timing control, numerically wrong on purpose), its
    loss averaged inside the slice only.

    The batch leads with ``(sync_period, global_batch, ...)``, the global
    batch split over ``(dcn, data)`` jointly: slices take contiguous row
    blocks, the within-slice data axis divides them (:meth:`shard_batch`).
    """

    inner_axis, outer_axis = "data", DCN_AXIS

    def __init__(self, mesh: Mesh, sync_period: int, *,
                 outer_lr: float = 1.0, outer_momentum: float = 0.0,
                 outer: str = "on", device=None):
        for ax in (self.inner_axis, self.outer_axis):
            if ax not in mesh.sizes:
                raise ValueError(
                    f"mesh has no axis {ax!r} (axes: {tuple(mesh.sizes)}); "
                    "build it with two_tier_mesh()")
        if sync_period < 1:
            raise ValueError(f"sync_period must be >= 1, got {sync_period}")
        if outer not in ("on", "off"):
            raise ValueError(f"outer must be 'on' or 'off', got {outer!r}")
        self.mesh = mesh
        self.sync_period = sync_period
        self.outer_lr = float(outer_lr)
        self.outer_momentum = float(outer_momentum)
        self.outer = outer
        self.n_slices = mesh.sizes[self.outer_axis]
        self.slice_world = mesh.sizes[self.inner_axis]
        self.world = self.n_slices * self.slice_world
        self.device = resolve_device(device)

    # ---- state / data placement -------------------------------------------

    def init(self, state) -> TwoTierState:
        """Wrap an inner ``TrainState`` with zeroed outer momentum over
        its float parameters."""
        momentum = {n: torch.zeros_like(p.detach())
                    for n, p in state.model.named_parameters()
                    if p.is_floating_point()}
        return TwoTierState(inner=state, outer_momentum=momentum)

    def replicate(self, tt: TwoTierState) -> TwoTierState:
        """Every rank holds its own replica: broadcast rank 0's parameters
        and outer momentum over the world, so the replicas start equal."""
        world, _ = world_and_rank()
        if world > 1:
            with torch.no_grad():
                for t in [*tt.inner.model.parameters(),
                          *tt.outer_momentum.values()]:
                    dist.broadcast(t.data, src=0)
        return tt

    def _row_block(self, rows: int) -> tuple[int, int]:
        """This rank's contiguous rows of a global batch of ``rows``: its
        index over ``(dcn, data)`` jointly, slices outermost."""
        part = (self.mesh.axis(self.outer_axis).index * self.slice_world
                + self.mesh.axis(self.inner_axis).index)
        return ((part * rows) // self.world,
                ((part + 1) * rows) // self.world)

    def shard_batch(self, batch: dict, *,
                    leading_time_axis: bool = True) -> dict:
        """This rank's contiguous row block of a host super-batch (rows
        on axis 1 with the leading time axis, else 0), on the device."""
        axis = 1 if leading_time_axis else 0
        out = {}
        for k, v in batch.items():
            lo, hi = self._row_block(int(np.shape(v)[axis]))
            out[k] = torch.as_tensor(np.asarray(v)).narrow(axis, lo, hi - lo)
        return to_device(out, self.device)

    # ---- accounting --------------------------------------------------------

    def outer_float_bytes(self, tt: TwoTierState) -> int:
        """Bytes the outer sync moves a slice a round: the float
        parameter delta plus the float inner-optimizer state (Adam's step
        count stays out, as optax's int count does)."""
        total = sum(p.numel() * p.element_size()
                    for p in tt.inner.model.parameters()
                    if p.is_floating_point())
        return total + sum(t.numel() * t.element_size() for t in
                           _float_moments(tt.inner.optimizer).values())

    # ---- the outer round ----------------------------------------------------

    def _outer_pmean(self, tree: dict) -> dict:
        return cc.pmean(tree, self.outer_axis, mesh=self.mesh)

    def make_train_step(self, loss_fn: LossFn):
        """``(TwoTierState, batches) -> (TwoTierState, {"loss"})``; the
        inner ``step`` moves by ``sync_period`` a call."""
        mu = self.outer_momentum

        def step(tt: TwoTierState, batches: dict):
            state = tt.inner
            batches = to_device(batches, self.device)
            params = {n: p for n, p in state.model.named_parameters()
                      if p.is_floating_point()}
            anchor = {n: p.detach().clone() for n, p in params.items()}
            losses = []
            for j in range(self.sync_period):
                (loss, _), g = value_and_grad(
                    loss_fn, state.model, {k: v[j] for k, v in
                                           batches.items()})
                # dense sync DP inside the slice
                state = state.apply_gradients(
                    cc.pmean(g, self.inner_axis, mesh=self.mesh))
                losses.append(loss)
            momentum = tt.outer_momentum
            if self.outer == "on":
                with torch.no_grad():
                    # the round's collectives across slices: the delta
                    # and the float optimizer state
                    delta = self._outer_pmean(
                        {n: anchor[n] - p for n, p in params.items()})
                    momentum = {n: mu * momentum[n] + d
                                for n, d in delta.items()}
                    for n, p in params.items():
                        p.copy_(anchor[n] - self.outer_lr
                                * (delta[n] + mu * momentum[n]))
                    moments = _float_moments(state.optimizer)
                    if moments:
                        for k, t in self._outer_pmean(moments).items():
                            moments[k].copy_(t)
            loss_axes = ((self.outer_axis, self.inner_axis)
                         if self.outer == "on" else self.inner_axis)
            mets = {"loss": cc.pmean(torch.stack(losses).mean(), loss_axes,
                                     mesh=self.mesh)}
            return TwoTierState(state, momentum), mets

        return step
