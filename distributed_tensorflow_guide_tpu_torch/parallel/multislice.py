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


def make_kv_block_transfer(mesh: Mesh, *, src_slice: int = 0,
                           dst_slice: int = 1):
    """The disaggregated prefill -> decode KV handoff as a collective:
    ``xfer(buf)`` ships a ``(blocks, payload)`` buffer from the rank of
    slice ``src_slice`` to the rank of slice ``dst_slice`` at the same
    place inside its slice, as ONE send / receive pair on the ``dcn``
    process group (a single-hop ``ppermute``: a migration has one
    producer and one consumer, so no ring). The receiver gets the
    sender's buffer; every other rank gets zeros. It runs under gloo on
    the CPU (and when ranks share one card, staged through pinned host
    memory) and under NCCL where each rank has its own card, and
    :class:`~..collectives.collectives.CommTrace` counts it as
    ``ppermute[dcn]``, so its bytes can be held to the migration closed
    form (``serve/paged_cache.kv_migration_bytes``). The fleet itself
    moves KV through the host (``serve/fleet.py``), as the JAX package's
    does; this is the device-to-device path a fleet spread over slices
    would take. Every rank must call ``xfer``."""
    n = mesh.axis(DCN_AXIS).size
    if n < 2:
        raise ValueError(
            f"kv block transfer needs >= 2 slices on {DCN_AXIS!r}, "
            f"got {n}")
    perm = [(src_slice % n, dst_slice % n)]

    def xfer(buf: torch.Tensor) -> torch.Tensor:
        return cc.ppermute(buf, DCN_AXIS, perm, mesh=mesh)

    return xfer


# ---- program contracts (analysis/) ------------------------------------------


def lint_contracts():
    """Contracts of one outer round at both outer settings and of the KV
    transfer between slices, on 2 slices of the world (4 ranks a slice at
    8). The load-bearing one is ``outer="off"``: no collective and no
    byte on ``dcn``, the metric included, because it is the timing
    control with no cross-slice traffic. ``outer="on"`` pins the whole
    round's cross-slice budget.

    The census counts executed calls, and a tree is one call: the inner
    ``pmean`` runs once an inner step (``sync_period`` = 2 calls, where
    the JAX census counts its scan body once), the outer sync is two
    trees over ``dcn`` (the parameter delta and the float optimizer
    state; the JAX census counts one site a leaf, 8), and the metric is
    one ``pmean`` over ``(dcn, data)`` (``outer="on"``) or over ``data``.
    The bytes are the closed forms.

    PyTorch has no donation, and a round returns a new ``TwoTierState``:
    the inner state is updated in place, the outer momentum replaced. So
    these contracts declare none; the JAX ones donate the state."""
    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        CostPin,
        CostSpec,
        ProgramContract,
    )
    from distributed_tensorflow_guide_tpu_torch.analysis.cost import (
        closed_forms,
    )

    sync_period, n_slices, grad_bytes = 2, 2, 4288
    # the tiny MLP's float state the outer sync averages: the parameters
    # and SGD's momentum
    float_state_bytes = 2 * grad_bytes

    def _dcn_expect():
        return closed_forms().outer_sync_bytes(float_state_bytes, n_slices)

    def _inner_expect(n_metric_pmeans):
        def expect():
            common = closed_forms()
            ici = world_and_rank()[0] // n_slices
            return (sync_period * common.dp_allreduce_bytes(grad_bytes, ici)
                    + n_metric_pmeans * common.dp_allreduce_bytes(4, ici))

        return expect

    def _joint_expect():
        # the loss over both tiers: every rank of the world
        return closed_forms().dp_allreduce_bytes(4, world_and_rank()[0])

    def build(outer):
        def _build(device):
            from distributed_tensorflow_guide_tpu_torch.analysis.fixtures \
                import tiny_mlp

            loss_fn, state, batch = tiny_mlp(device)
            mesh = two_tier_mesh(MeshSpec(data=-1), n_slices=n_slices)
            # the joint axis's groups are made collectively: here, not
            # inside the recorded round
            mesh.axis((DCN_AXIS, "data"))
            ms = MultiSliceLocalSGD(mesh, sync_period=sync_period,
                                    outer=outer, device=device)
            lo, hi = ms._row_block(len(batch["x"]))
            batches = {k: torch.stack([v[lo:hi]] * sync_period)
                       for k, v in batch.items()}
            return ms.make_train_step(loss_fn), (ms.init(state), batches)

        return _build

    sources = ("distributed_tensorflow_guide_tpu_torch.parallel.multislice",
               "distributed_tensorflow_guide_tpu_torch.collectives."
               "collectives")
    return [
        ProgramContract(
            name="multislice_outer_on_round",
            build=build("on"),
            policy="f32",
            collectives={
                "psum[data]": sync_period,  # the inner gradient pmeans
                "psum[dcn]": 2,  # the delta tree + the optimizer-state tree
                "psum[dcn,data]": 1,  # the metric over both tiers
            },
            sources=sources,
            cost=CostSpec(
                pins=(
                    CostPin("collective_bytes[psum[dcn]]", _dcn_expect,
                            note="outer_sync_bytes over the float state "
                                 "(parameters + momentum), once a round"),
                    CostPin("collective_bytes[psum[data]]",
                            _inner_expect(0),
                            note="sync_period inner gradient all-reduces "
                                 "inside the slice"),
                    CostPin("collective_bytes[psum[dcn,data]]",
                            _joint_expect,
                            note="the loss over both tiers"),
                ),
                max_peak_live_bytes=40960),  # 34,584 observed
            world=8,
            notes="two-tier round: dense inner steps, one DCN sync"),
        ProgramContract(
            name="multislice_outer_off_round",
            build=build("off"),
            policy="f32",
            # strict: the inner pmeans + the in-slice metric and nothing
            # else; any dcn collective fails the lint
            collectives={"psum[data]": sync_period + 1},
            sources=sources,
            cost=CostSpec(
                pins=(
                    # the byte side of the DCN-free promise (an absent
                    # key reads 0.0)
                    CostPin("collective_bytes[psum[dcn]]", 0.0,
                            note="outer=off moves no byte over DCN"),
                    CostPin("collective_bytes[psum[data]]",
                            _inner_expect(1),
                            note="the inner all-reduces + the in-slice "
                                 "scalar metric"),
                ),
                # 26,196 observed: no delta, no anchor sync
                max_peak_live_bytes=32768),
            world=8,
            notes="outer=off is DCN-free by contract (the timing control)"),
        _kv_transfer_contract(),
    ]


def _kv_transfer_contract():
    """Contract of the KV-block migration between slices: one
    point-to-point ``ppermute[dcn]`` and nothing else (strict: a stray
    reduction would be a synchronisation the migration must not have),
    every rank calling it once. 4 blocks of (L=2, H=2, block 8, hd 8) f32
    a rank. The sending slice's ranks record P, the receiving slice's 0,
    so the world mean is ``kv_migration_bytes / n_slices``: the JAX
    contract's pin, bytes × hops / n_devices.

    PyTorch has no donation: the transfer returns a new buffer on every
    rank (the message on a receiver, zeros elsewhere) and leaves ``buf``
    as it was, so the contract declares none; the JAX one donates it."""
    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        CostPin,
        CostSpec,
        ProgramContract,
    )
    from distributed_tensorflow_guide_tpu_torch.analysis.cost import (
        closed_forms,
    )

    L, H, BS, HD, NB = 2, 2, 8, 8, 4
    n_slices = 2

    def _xfer_expect():
        return closed_forms().kv_migration_bytes(
            NB, L, H, BS, HD, activation_dtype_bytes=4) / n_slices

    def _build(device):
        mesh = two_tier_mesh(MeshSpec(data=-1), n_slices=n_slices)
        fn = make_kv_block_transfer(mesh)
        elems_per_block = 2 * L * H * BS * HD  # the K and V rows
        buf = torch.from_numpy(np.random.RandomState(0).standard_normal(
            (NB, elems_per_block)).astype(np.float32)).to(device)
        return fn, (buf,)

    return ProgramContract(
        name="serve_kv_block_transfer_dcn",
        build=_build,
        policy="f32",
        collectives={"ppermute[dcn]": 1},
        sources=("distributed_tensorflow_guide_tpu_torch.parallel."
                 "multislice",),
        cost=CostSpec(
            pins=(
                CostPin("collective_bytes[ppermute[dcn]]", _xfer_expect,
                        note="kv_migration_bytes / n_slices: one hop from "
                             "the sending slice"),
            ),
            # the buffer and the one the transfer returns: 16,384
            max_peak_live_bytes=16384),
        world=8,
        notes="KV migration across slices: one ppermute, nothing else")
