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
    backward all-reduce, ``bucket_bytes`` a bucket
    (``overlap.DEFAULT_BUCKET_BYTES`` when None). ``compress`` ("int8" |
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
