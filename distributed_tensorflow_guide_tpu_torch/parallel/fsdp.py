"""Fully-sharded data parallelism (ZeRO-3 / FSDP) over the ``data`` axis.

The guide's synchronous track replicates every variable on every worker
(``SyncReplicasOptimizer``, ``MultiWorkerMirroredStrategy``): parameter
memory grows with the model on every device. FSDP shards the parameters
and the optimizer state over the same ``data`` axis the batch is split
over, and materialises each parameter only for the step that uses it.

The JAX package gives each large leaf a ``NamedSharding`` and lets GSPMD
infer ZeRO-3's schedule, or (``prefetch`` on) writes it per leaf with the
markers of its ``parallel/overlap.py``. A rank of this package is a process,
so the layout and the schedule are stated here:

* :func:`shard_spec_for` (the JAX function): a leaf of at least
  ``min_size`` elements is cut along its largest dim that divides by the
  world; the rest stay replicated;
* each rank holds its shard of every sharded leaf and the whole of every
  replicated one (:meth:`FSDP.shard`, which slices a host state dict, so
  no device ever holds the full tree); the optimizer is built over these
  tensors, so its moments are sharded by construction (no counterpart of
  ``state_shardings`` is needed);
* the step runs the explicit per-leaf schedule of the JAX package's
  ``_make_prefetch_step``: ``overlap.gather_params`` all-gathers each
  sharded leaf (reduce-scatter of the mean gradient backward) and passes
  each replicated one with a ``pmean`` backward, the loss runs on the
  gathered parameters through ``torch.func.functional_call``, and the
  gradients come back in shard layout. The gathered copies live through
  the backward, as the JAX schedule keeps them: no re-gather backward.

GSPMD's inferred schedule has no torch counterpart, so both ``prefetch``
values run this one schedule: the same collectives, synchronous, with
the same bytes and numbers. ``prefetch`` is kept for parity with the JAX
signature (``"auto"`` resolves on under NCCL, and :attr:`FSDP.prefetch`
says so). A gather issued ahead of its use would overlap compute only if
it were waited on where the leaf is used (a pre-hook per block); that
schedule is not written yet.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Callable

import torch
from torch import nn

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh
from distributed_tensorflow_guide_tpu_torch.parallel import overlap as ov
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    to_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    LossFn,
    value_and_grad,
)

Spec = tuple  # one entry per dim: the axis name it is cut over, or None


def shard_spec_for(shape: tuple[int, ...], world: int,
                   min_size: int = 2 ** 14, axis: str = "data") -> Spec:
    """The FSDP spec of one parameter: its largest dim that divides by
    ``world`` is cut over ``axis``; tiny or indivisible leaves stay
    replicated (``()``). The JAX function's ``PartitionSpec`` as a
    tuple."""
    n = 1
    for d in shape:
        n *= d
    if n < min_size:
        return ()
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in dims:
        if shape[i] % world == 0 and shape[i] >= world:
            spec = [None] * len(shape)
            spec[i] = axis
            return tuple(spec)
    return ()


def param_specs(full: Mapping[str, torch.Tensor], world: int,
                min_size: int = 2 ** 14, axis: str = "data"
                ) -> dict[str, Spec]:
    """:func:`shard_spec_for` of every entry of a full state dict."""
    return {n: shard_spec_for(tuple(t.shape), world, min_size, axis)
            for n, t in full.items()}


def shard_state_dict(full: Mapping[str, torch.Tensor],
                     specs: Mapping[str, Spec], world: int, index: int,
                     axis: str = "data") -> dict[str, torch.Tensor]:
    """Shard ``index`` of every entry of a full state dict: new contiguous
    tensors on the entry's device (a replicated entry is copied
    whole)."""
    out = {}
    for n, t in full.items():
        dim = ov.sharded_dim(specs[n], axis)
        t = t.detach()
        part = t if dim is None else t.chunk(world, dim=dim)[index]
        out[n] = part.clone(memory_format=torch.contiguous_format)
    return out


def merge_shards(parts: list[Mapping[str, torch.Tensor]],
                 specs: Mapping[str, Spec], axis: str = "data"
                 ) -> dict[str, torch.Tensor]:
    """The full state dict from every rank's shards, in ``data`` order
    (the inverse of :func:`shard_state_dict`)."""
    out = {}
    for n in parts[0]:
        dim = ov.sharded_dim(specs[n], axis)
        out[n] = (parts[0][n] if dim is None
                  else torch.cat([p[n] for p in parts], dim=dim))
    return out


def fsdp_comm_terms(sharded_param_bytes: float, world: int,
                    replicated_grad_bytes: float = 0.0) -> dict:
    """ZeRO-3's bytes on the wire a step and device (the JAX package's
    ``benchmarks/common.py`` ``fsdp_comm_terms``): the forward all-gather
    and the backward reduce-scatter, one pass at (n−1)/n each over the
    sharded leaves' full bytes, and the two-pass all-reduce the
    replicated leaves' gradients still pay."""
    if world <= 1:
        return {"param_all_gather": 0.0, "grad_reduce_scatter": 0.0,
                "replicated_grad_allreduce": 0.0}
    frac = (world - 1) / world
    return {"param_all_gather": sharded_param_bytes * frac,
            "grad_reduce_scatter": sharded_param_bytes * frac,
            "replicated_grad_allreduce": 2.0 * replicated_grad_bytes * frac}


def _meta_copy(model: nn.Module) -> nn.Module:
    """``model``'s structure with every parameter and buffer on the meta
    device (nothing is copied)."""
    memo = {}
    for t in list(model.parameters()) + list(model.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (nn.Parameter(meta, requires_grad=t.requires_grad)
                       if isinstance(t, nn.Parameter) else meta)
    return copy.deepcopy(model, memo)


def _set_tensor(module: nn.Module, name: str, t: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    for p in path:
        module = getattr(module, p)
    if leaf in module._parameters:
        module._parameters[leaf] = nn.Parameter(
            t, requires_grad=module._parameters[leaf].requires_grad)
    else:
        module._buffers[leaf] = t


class FSDP:
    """Fully-sharded train and eval steps over ``mesh``'s ``axis``.

    ``device=None`` is this rank's CUDA card (raises without one);
    ``device="cpu"`` runs the plain versions of the kernels. Build the
    rank's module with :meth:`shard` and its optimizer over that module's
    parameters (the shards); each rank's batch is its own share.
    """

    def __init__(self, mesh: Mesh, axis: str = "data",
                 min_shard_size: int = 2 ** 14, *, prefetch="off",
                 device=None):
        self.mesh = mesh
        self.axis = axis
        ax = mesh.axis(axis)
        self.world, self.index = ax.size, ax.index
        self.min_shard_size = min_shard_size
        self.prefetch = ov.resolve_prefetch(prefetch,
                                            backend=ov.axis_backend(ax))
        self.device = resolve_device(device)
        self.specs: dict[str, Spec] = {}

    # -- layout ----------------------------------------------------------------

    def shard_state_dict(self, full: Mapping[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
        """This rank's shards of a full (host) state dict; the layout is
        kept for the steps and :meth:`gather_state_dict`."""
        self.specs = param_specs(full, self.world, self.min_shard_size,
                                 self.axis)
        return shard_state_dict(full, self.specs, self.world, self.index,
                                self.axis)

    def shard(self, model: nn.Module) -> nn.Module:
        """This rank's module: ``model``'s structure holding the shard of
        every sharded parameter and the whole of every replicated one and
        of every buffer, on the step's device. ``model`` (on the host) is
        left as it is; it is called only through the steps."""
        params = dict(model.named_parameters())
        shards = self.shard_state_dict(params)
        local = _meta_copy(model)
        for n, t in shards.items():
            _set_tensor(local, n, t.to(self.device))
        for n, b in model.named_buffers():
            _set_tensor(local, n, b.detach().clone().to(self.device))
        return local

    def gather_state_dict(self, local) -> dict[str, torch.Tensor]:
        """The full parameters (or gradients) from every rank's shards, on
        every rank: each sharded entry all-gathered along its dim. Takes
        the rank's module or a dict keyed like its parameters; every rank
        of the axis calls it."""
        if isinstance(local, nn.Module):
            local = dict(local.named_parameters())
        out = {}
        for n, t in local.items():
            dim = ov.sharded_dim(self.specs[n], self.axis)
            out[n] = (t.detach() if dim is None else cc.all_gather(
                t.detach(), self.axis, tiled=True, gather_axis=dim,
                mesh=self.mesh))
        return out

    def state_bytes(self, module: nn.Module, optimizer=None) -> dict:
        """This rank's resident bytes: its parameters and, given the
        optimizer, the floating tensors of its state (the moments)."""
        out = {"params": sum(p.numel() * p.element_size()
                             for p in module.parameters())}
        if optimizer is not None:
            out["optimizer"] = sum(
                t.numel() * t.element_size()
                for st in optimizer.state.values() for k, t in st.items()
                if isinstance(t, torch.Tensor) and k != "step")
        return out

    # -- steps -------------------------------------------------------------

    def _check(self, module: nn.Module) -> None:
        if not self.specs:
            raise ValueError("build the rank's module with FSDP.shard "
                             "first")
        dev = next(module.parameters()).device
        if dev != self.device:
            raise ValueError(f"the module lives on {dev}, the step on "
                             f"{self.device}")

    def value_and_grad(self, loss_fn: LossFn, module: nn.Module, batch):
        """((loss, metrics), gradients) of this rank's batch through the
        per-leaf schedule: the loss on the gathered parameters, the
        gradients in shard layout and already averaged over the axis. The
        loss and metrics are this rank's own."""
        self._check(module)
        shards = {n: p for n, p in module.named_parameters()
                  if p.requires_grad}

        def sharded_loss(m, b):
            full = ov.gather_params(shards, self.specs, self.axis,
                                    mesh=self.mesh)
            return ov.call_with_params(loss_fn, m, full, b)

        return value_and_grad(sharded_loss, module, batch)

    def make_train_step(self, loss_fn: LossFn):
        """``(state, batch) -> (state, {"loss", **metrics})``: the
        per-leaf schedule, one sharded update; each metric ``pmean``-ed
        over the axis (one all-reduce a metric, as the JAX step)."""

        def step(state, batch):
            batch = to_device(batch, self.device)
            (loss, mets), grads = self.value_and_grad(loss_fn, state.model,
                                                      batch)
            state = state.apply_gradients(grads)
            return state, {k: cc.pmean(v, self.axis, mesh=self.mesh)
                           for k, v in {"loss": loss, **mets}.items()}

        return step

    def make_eval_step(self, metric_fn: Callable[[nn.Module, Any], dict]):
        """``(state, batch) -> metrics`` without gradients: the parameters
        gathered leaf by leaf for the forward, the metrics averaged over
        the axis."""

        def eval_step(state, batch):
            self._check(state.model)
            with torch.no_grad():
                full = self.gather_state_dict(state.model)
                mets = ov.call_with_params(metric_fn, state.model, full,
                                           to_device(batch, self.device))
            return {k: cc.pmean(v, self.axis, mesh=self.mesh)
                    for k, v in mets.items()}

        return eval_step


# ---- program contracts (analysis/) ------------------------------------------


def lint_contracts():
    """Contract of the ZeRO-3 schedule on the auditor's tiny MLP over
    ``data`` = the world at ``min_shard_size=64``: the two matrices
    shard, the two biases replicate. Each sharded leaf makes one
    all-gather forward and one reduce-scatter backward, each replicated
    leaf one ``pmean`` backward, each metric one ``pmean``: the same calls
    as the JAX contract counts sites, since this step reduces leaf by leaf
    and metric by metric."""
    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        CostPin,
        CostSpec,
        DonationSpec,
        ProgramContract,
    )
    from distributed_tensorflow_guide_tpu_torch.analysis.cost import (
        closed_forms,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        world_and_rank,
    )

    n_sharded, n_replicated, n_metrics = 2, 2, 2
    sharded_bytes = (16 * 32 + 32 * 16) * 4  # the two matrices, whole
    replicated_bytes = (32 + 16) * 4  # the two biases

    def _term(name):
        def expect():
            common, world = closed_forms(), world_and_rank()[0]
            terms = common.fsdp_comm_terms(sharded_bytes, world,
                                           replicated_bytes)
            if name == "replicated_grad_allreduce":
                # the bias pmeans share the psum key with the 2 metrics
                return (terms[name] + n_metrics
                        * common.dp_allreduce_bytes(4, world))
            return terms[name]

        return expect

    def _build(device):
        from distributed_tensorflow_guide_tpu_torch.analysis.fixtures import (
            tiny_mlp,
        )
        from distributed_tensorflow_guide_tpu_torch.core.mesh import (
            MeshSpec,
            build_mesh,
        )
        from distributed_tensorflow_guide_tpu_torch.train.state import (
            TrainState,
        )

        loss_fn, state, batch = tiny_mlp()
        mesh = build_mesh(MeshSpec(data=-1))
        fsdp = FSDP(mesh, min_shard_size=64, prefetch=True, device=device)
        local = fsdp.shard(state.model)
        local_state = TrainState(local, torch.optim.SGD(
            local.parameters(), lr=0.1, momentum=0.9))
        per = len(batch["x"]) // fsdp.world
        share = {k: v[fsdp.index * per:(fsdp.index + 1) * per].to(device)
                 for k, v in batch.items()}
        return fsdp.make_train_step(loss_fn), (local_state, share)

    return [
        ProgramContract(
            name="fsdp_prefetch_train_step",
            build=_build,
            policy="f32",
            collectives={
                "all_gather[data]": n_sharded,
                "reduce_scatter[data]": n_sharded,
                "psum[data]": n_replicated + n_metrics,
            },
            donation=DonationSpec(argnums=(0,), mode="update"),
            sources=(
                "distributed_tensorflow_guide_tpu_torch.parallel.fsdp",
                "distributed_tensorflow_guide_tpu_torch.parallel.overlap",
                "distributed_tensorflow_guide_tpu_torch.collectives."
                "collectives",
            ),
            cost=CostSpec(
                pins=(
                    CostPin("collective_bytes[all_gather[data]]",
                            _term("param_all_gather"),
                            note="ZeRO-3 forward: both matrices "
                                 "unsharded, S·(n−1)/n"),
                    CostPin("collective_bytes[reduce_scatter[data]]",
                            _term("grad_reduce_scatter"),
                            note="ZeRO-3 backward: both matrix gradients "
                                 "resharded"),
                    CostPin("collective_bytes[psum[data]]",
                            _term("replicated_grad_allreduce"),
                            note="the bias pmeans + the 2 scalar metrics"),
                ),
                max_peak_live_bytes=10240),
            world=8,
            notes="ZeRO-3 schedule: a gather and a scatter a sharded leaf"),
    ]
