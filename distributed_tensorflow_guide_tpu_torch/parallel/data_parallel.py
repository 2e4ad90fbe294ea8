"""Synchronous data parallelism: the train and eval steps.

The JAX package's ``DataParallel`` builds one compiled SPMD step over a
mesh's ``data`` axis: per-shard forward and backward, an explicit
``pmean`` of the gradients, the same optimizer update everywhere. Here
every rank is a process holding a full replica: it runs its share of the
batch forward and backward, ``collectives.pmean`` averages the gradients
over the mesh's ``data`` axis (one flat all-reduce), and every rank
applies the same update, which keeps the replicas in lockstep without
ever broadcasting parameters. Without a mesh the world is one rank.

Models with BatchNorm keep their running statistics as module buffers.
Their steps (``make_train_step_with_stats``, ``make_eval_step_with_stats``)
run the module in train or eval mode, and the train step averages the
running statistics over the axis after each update, so that every replica
holds the same ones: the MultiWorkerMirroredStrategy behaviour.

``overlap=True`` moves the gradient all-reduce into the backward, one
async all-reduce per byte-budgeted bucket of parameters
(``parallel/overlap.py``); the step waits on them before the update and
skips its monolithic ``pmean``. The gradients are the same bits at two
ranks. ``"auto"`` is on where the ``data`` group runs over NCCL.
``compress="int8"`` (with ``overlap=True``) puts each bucket on the wire
in int8 through ``ops/quant.int8_pmean``'s shared-scale transform.

``steps_per_call=k`` (the reference's TF ``steps_per_run`` knob) runs k
optimizer steps a call, over a ``stacked_batch`` (every tensor leading
with k, one slice an inner step; ``prefetch`` and ``data/prefetch.py``
pack it) or the same batch k times, with the last inner step's metrics or,
with ``per_step_metrics``, each stacked to (k,). On the card the k steps
are one CUDA graph (``core/graphs.MultiStep``): the host launches one
graph a call where it launched thousands of kernels; ``step.eager`` is
the same step without capture, ``step.captured`` says which one runs. A
``data`` (or any) axis over gloo with more than one rank stages CUDA
tensors through host memory (``collectives.py``), which cannot sit in a
graph: such a step runs its k steps eagerly (``captured`` False). The
default ``steps_per_call=None`` is the one-step eager call.

Metrics leave the step as 0-d device tensors: nothing in the step forces
a host sync; a hook that reads a value pays for it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
import torch.distributed as dist

from distributed_tensorflow_guide_tpu_torch.collectives import collectives as cc
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.graphs import MultiStep
from distributed_tensorflow_guide_tpu_torch.core.mesh import (
    Mesh,
    single_device_mesh,
)
from distributed_tensorflow_guide_tpu_torch.obs.tracing import span
from distributed_tensorflow_guide_tpu_torch.parallel import overlap as ov
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    LossFn,
    accumulate_grads,
    value_and_grad,
)


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays or tensors) on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def capturable(mesh: Mesh, device: torch.device) -> bool:
    """Whether a step over ``mesh`` on ``device`` can be one CUDA graph:
    a CUDA device and no axis of more than one rank over gloo (whose
    CUDA messages go through host memory)."""
    if torch.device(device).type != "cuda":
        return False
    for name in mesh.sizes:
        g = mesh.axis(name).group
        if g is not None and dist.get_backend(g) != "nccl":
            return False
    return True


class DataParallel:
    """Build ``(state, batch) -> (state, metrics)`` train steps and
    ``(state, batch) -> metrics`` eval steps over ``mesh``'s ``axis``.

    ``mesh=None`` is a world of one rank. ``device=None`` is this rank's
    CUDA card (raises without one); ``device="cpu"`` runs the plain
    versions of the kernels. The state's module must already live on that
    device, with the same parameters on every rank; each rank's batch is
    its own share of the global batch and is moved there.

    ``overlap`` ("auto" | True | False, default off): the bucketed
    backward all-reduce, ``bucket_bytes`` a bucket (None: the tuning
    table's budget, ``overlap.resolve_bucket_bytes``, decided by the
    axis's first rank at the first step; ``overlap.DEFAULT_BUCKET_BYTES``
    without an entry and on the CPU). ``compress`` ("int8" |
    None / "off"): the buckets' wire in int8 (``ops/quant.int8_pmean``);
    it rides the bucketed backward, so it requires ``overlap=True``.
    """

    def __init__(self, mesh: Mesh | None = None, axis: str = "data", *,
                 overlap="off", bucket_bytes: int | None = None,
                 compress=None, device=None):
        self.mesh = mesh if mesh is not None else single_device_mesh()
        self.axis = axis
        ax = self.mesh.axis(axis)  # an axis the mesh has
        self.overlap = ov.resolve_overlap(overlap,
                                          backend=ov.axis_backend(ax))
        self.bucket_bytes = bucket_bytes
        self.compress = ov.resolve_compress(compress)
        if self.compress and not self.overlap:
            raise ValueError(
                "compress='int8' rides the bucketed backward — it "
                "requires overlap=True (the monolithic pmean path stays "
                "bitwise-exact by contract)")
        self.device = resolve_device(device)

    def _check(self, state):
        dev = next(state.model.parameters()).device
        if dev != self.device:
            raise ValueError(f"the model lives on {dev}, the step on "
                             f"{self.device}: move it with "
                             f"model.to({str(self.device)!r})")

    # ---- data placement --------------------------------------------------

    def shard_packed_batch(self, packed: dict) -> dict:
        """One ``steps_per_call`` super-batch (leading axis = inner step,
        ``data/prefetch.pack_batches``) on this rank's device: its share
        of the global batch, as every rank feeds its own."""
        return to_device(packed, self.device)

    def prefetch(self, source, *, depth: int = 2, steps_per_call: int = 1,
                 drop_remainder: bool = True):
        """``source`` (host batches) through the device-prefetch stage
        (``data/prefetch.py``) onto this rank's device; with
        ``steps_per_call > 1`` each item is a packed super-batch for the
        k-step train step."""
        from distributed_tensorflow_guide_tpu_torch.data.prefetch import (
            prefetch_to_device,
        )

        return prefetch_to_device(source, depth=depth, device=self.device,
                                  steps_per_call=steps_per_call,
                                  drop_remainder=drop_remainder)

    # ---- train steps -------------------------------------------------------

    def _context(self):
        """What a step runs inside (``TensorParallel``: its mesh)."""
        return contextlib.nullcontext()

    def _finish(self, one, steps_per_call, stacked_batch: bool,
                per_step_metrics: bool, optimizer_of=None):
        """The step around ``one(state, device batch)``: the one-step
        eager call, or :class:`MultiStep` for ``steps_per_call``."""
        if steps_per_call is None:
            MultiStep.check_args(steps_per_call, stacked_batch)

            def step(state, batch):
                self._check(state)
                with self._context():
                    return one(state, to_device(batch, self.device))

            return step
        return MultiStep(
            one, steps_per_call=steps_per_call, stacked_batch=stacked_batch,
            per_step_metrics=per_step_metrics,
            capture=capturable(self.mesh, self.device), device=self.device,
            prepare=lambda b: to_device(b, self.device), check=self._check,
            context=self._context, optimizer_of=optimizer_of)

    def make_train_step(self, loss_fn: LossFn, *, accum_steps: int = 1,
                        steps_per_call: int | None = None,
                        stacked_batch: bool = False,
                        per_step_metrics: bool = False):
        """``(state, batch) -> (state, {"loss", **metrics})``.

        The gradients, the loss and the metrics are averaged over the axis
        (``pmean``) before the one update. ``accum_steps > 1`` splits this
        rank's batch into that many equal microbatches and averages their
        gradients first: the full batch's numerics, with activation memory
        divided by ``accum_steps``, and still one all-reduce per step. The
        batch length must divide by it. It cannot be combined with
        ``overlap``, which would all-reduce every microbatch.

        ``steps_per_call``, ``stacked_batch``, ``per_step_metrics``: k
        optimizer steps a call (the module docstring); the optimizer of a
        captured step must keep its counter on the card (``Adam(...,
        capturable=True)``).
        """
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if self.overlap and accum_steps > 1:
            raise ValueError(
                "overlap=True is incompatible with accum_steps > 1: the "
                "bucketed backward reduces each microbatch's gradients, "
                "which multiplies the all-reduce traffic by "
                f"accum_steps={accum_steps}")

        def one(state, batch):
            if self.overlap:  # the backward reduces them, bucket by bucket
                pending = []  # this step's buckets
                bucketed = ov.bucketed_loss_fn(
                    loss_fn, self.axis, self.bucket_bytes, pending=pending,
                    mesh=self.mesh, compress=self.compress)
                try:
                    (loss, mets), grads = value_and_grad(
                        bucketed, state.model, batch)
                    ov.wait_buckets(pending)
                finally:
                    ov.drop_buckets(pending)  # the hooks of a step that raised
            elif accum_steps == 1:
                (loss, mets), grads = value_and_grad(loss_fn, state.model,
                                                     batch)
            else:
                n = next(iter(batch.values())).shape[0]
                if n % accum_steps:
                    raise ValueError(
                        f"a batch of {n} rows is not divisible by "
                        f"accum_steps={accum_steps}")
                micro = {k: v.reshape(accum_steps, n // accum_steps,
                                      *v.shape[1:])
                         for k, v in batch.items()}
                grads, (losses, metas) = accumulate_grads(
                    loss_fn, state.model, micro, accum_steps)
                loss = losses.mean()
                mets = {k: v.mean() for k, v in metas.items()}
            if not self.overlap:
                with span(None, "grad_sync"):
                    grads = cc.pmean(self.complete_grads(grads), self.axis,
                                     mesh=self.mesh)
            state = state.apply_gradients(grads)
            return state, cc.pmean({"loss": loss, **mets}, self.axis,
                                   mesh=self.mesh)

        return self._finish(one, steps_per_call, stacked_batch,
                            per_step_metrics)

    def complete_grads(self, grads: dict) -> dict:
        """This rank's gradients, made whole before the average over the
        axis: here they already are (``TensorParallel`` sums its
        sequence-parallel ones)."""
        return grads

    def make_train_step_with_stats(self, loss_fn: LossFn, *,
                                   steps_per_call: int | None = None,
                                   stacked_batch: bool = False,
                                   per_step_metrics: bool = False):
        """``(state, batch) -> (state, {"loss", **metrics})`` for a module
        with BatchNorm running statistics: :meth:`make_train_step` with the
        forward in train mode (batch statistics; each BatchNorm moves its
        running statistics by this rank's batch), and after the update the
        running statistics averaged over the axis too (one flat
        all-reduce), so the replicas keep bitwise-equal statistics.
        ``steps_per_call`` and its two companions as there.
        """
        train_step = self.make_train_step(loss_fn)

        def one(state, batch):
            state.model.train()
            state, mets = train_step(state, batch)
            stats = {n: b for n, b in state.model.named_buffers()
                     if b.is_floating_point()}
            for n, b in cc.pmean(stats, self.axis, mesh=self.mesh).items():
                stats[n].copy_(b)
            return state, mets

        return self._finish(one, steps_per_call, stacked_batch,
                            per_step_metrics)

    def make_eval_step_with_stats(self, metric_fn: Callable[
            [torch.nn.Module, Any], dict]):
        """``(state, batch) -> metrics`` in eval mode (the running
        statistics, nothing written back), averaged over the axis; the
        module's mode is restored afterwards."""
        plain = self.make_eval_step(metric_fn)

        def eval_step(state, batch):
            was_training = state.model.training
            state.model.eval()
            try:
                return plain(state, batch)
            finally:
                state.model.train(was_training)

        return eval_step

    def make_eval_step(self, metric_fn: Callable[[torch.nn.Module, Any],
                                                 dict]):
        """``(state, batch) -> metrics``, without gradients, averaged over
        the axis."""

        def eval_step(state, batch):
            self._check(state)
            with torch.no_grad(), self._context():
                mets = metric_fn(state.model, to_device(batch, self.device))
            return cc.pmean(mets, self.axis, mesh=self.mesh)

        return eval_step


# ---- program contracts (analysis/) ------------------------------------------


def lint_contracts():
    """Contracts of the data-parallel train step on the auditor's tiny MLP
    over ``data`` = the world (8 ranks, one batch row each): the
    monolithic step and the bucketed-overlap step, whose collective count
    is derived from the bucket partition (``bucket_bytes=1``: one bucket a
    leaf), plain and with the int8 wire.

    The census counts executed calls, and a tree goes over the wire as
    one flat all-reduce. So the monolithic step makes 2 ``psum[data]``
    calls, the gradient tree and the metrics tree (loss and mae), where
    the JAX contract counts 3 sites (one a metric) and its trace shows 6;
    the bucketed step makes one a bucket plus the metrics tree. The bytes
    are the invariant: each pin is the ring closed form."""
    import dataclasses

    import numpy as np

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

    def build(overlap_on, compress=None):
        def _build(device):
            from distributed_tensorflow_guide_tpu_torch.analysis.fixtures \
                import tiny_mlp
            from distributed_tensorflow_guide_tpu_torch.core.mesh import (
                MeshSpec,
                build_mesh,
            )

            loss_fn, state, batch = tiny_mlp(device)
            mesh = build_mesh(MeshSpec(data=-1))
            ax = mesh.axis("data")
            per = len(batch["x"]) // ax.size
            share = {k: v[ax.index * per:(ax.index + 1) * per]
                     for k, v in batch.items()}
            # bucket_bytes=1 is given, so no tuning-table broadcast runs
            dp = DataParallel(mesh, overlap=overlap_on,
                              bucket_bytes=1 if overlap_on else None,
                              compress=compress, device=device)
            return dp.make_train_step(loss_fn), (state, share)

        return _build

    sources = ("distributed_tensorflow_guide_tpu_torch.parallel."
               "data_parallel",
               "distributed_tensorflow_guide_tpu_torch.parallel.overlap",
               "distributed_tensorflow_guide_tpu_torch.collectives."
               "collectives")
    # the tiny MLP's leaves; at bucket_bytes=1 one bucket a leaf
    leaf_shapes = [(16, 32), (32,), (32, 16), (16,)]
    grad_bytes = sum(int(np.prod(s)) * 4 for s in leaf_shapes)  # 4288
    n_buckets = len(ov.bucket_assignment(
        [torch.zeros(s) for s in leaf_shapes], bucket_bytes=1))

    def _psum_expect(compress=None):
        # the gradient tree (f32 or int8 on the wire) + the loss and mae
        def expect():
            common, world = closed_forms(), world_and_rank()[0]
            return (common.dp_allreduce_bytes(grad_bytes, world, compress)
                    + 2 * common.dp_allreduce_bytes(4, world))

        return expect

    def _scale_expect():
        # one f32 amax a bucket rides a ring pmax
        return n_buckets * closed_forms().dp_allreduce_bytes(
            4, world_and_rank()[0])

    def _flops_expect():
        # a rank's rows: two forward products and three backward ones (no
        # input gradient at the first layer), 2·rows·16·32 each
        rows = 8 // world_and_rank()[0]
        return 5 * 2.0 * rows * 16 * 32

    dp_cost = CostSpec(
        pins=(
            CostPin("collective_bytes[psum[data]]", _psum_expect(),
                    note="2·G·(n−1)/n gradient ring + the 2 scalar "
                         "metrics"),
            CostPin("flops", _flops_expect,
                    note="5 products a rank: no input gradient at layer 0"),
        ),
        # 13,896 observed a rank (parameters, batch share, gradients,
        # the momentum the first step makes)
        max_peak_live_bytes=16384)
    return [
        ProgramContract(
            name="dp_train_step",
            build=build(False),
            policy="f32",
            # the gradient tree + the metrics tree (loss, mae): one call
            # each
            collectives={"psum[data]": 2},
            donation=DonationSpec(argnums=(0,), mode="update"),
            sources=sources,
            cost=dp_cost,
            world=8,
            notes="sync-DP mono step: one gradient all-reduce a step"),
        ProgramContract(
            name="dp_overlap_train_step",
            build=build(True),
            policy="f32",
            # one all-reduce a bucket, issued mid-backward, + the metrics
            # tree: the bucket partition is the expectation
            collectives={"psum[data]": n_buckets + 1},
            donation=DonationSpec(argnums=(0,), mode="update"),
            sources=sources,
            # the same bytes as the mono step: bucketing changes when the
            # all-reduces run, not what they move (peak 11,724 observed on
            # the CPU, 13,896 on the card)
            cost=dp_cost,
            world=8,
            notes=f"bucketed backward: {n_buckets} buckets -> "
                  f"{n_buckets} gradient all-reduces"),
        ProgramContract(
            name="dp_overlap_int8_round",
            build=build(True, compress="int8"),
            policy="f32",
            # one int8 psum a bucket + the f32 metrics tree, and one f32
            # scalar pmax a bucket: the shared scale of the int8 wire
            collectives={"psum[data]": n_buckets + 1,
                         "pmax[data]": n_buckets},
            donation=DonationSpec(argnums=(0,), mode="update"),
            sources=sources + ("distributed_tensorflow_guide_tpu_torch.ops."
                               "quant",),
            cost=dataclasses.replace(dp_cost, pins=(
                CostPin("collective_bytes[psum[data]]",
                        _psum_expect("int8"),
                        note="the gradient ring at 1 byte an element + "
                             "the 2 f32 scalar metrics"),
                CostPin("collective_bytes[pmax[data]]", _scale_expect,
                        note="one f32 scale a bucket"),
                dp_cost.pins[1]),
                # the f32 buffers beside their int8 copies: 16,400
                # observed
                max_peak_live_bytes=18432),
            world=8,
            notes="int8 wire: the payload in psum, the scale in pmax"),
    ]
