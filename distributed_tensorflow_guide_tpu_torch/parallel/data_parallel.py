"""Synchronous data parallelism: the train and eval steps.

The JAX package's ``DataParallel`` builds one compiled SPMD step over a
mesh's ``data`` axis: per-shard forward and backward, an explicit
``pmean`` of the gradients, the same optimizer update everywhere. This
slice ports the single-process form: with no process group (or one of
size 1) the world is one, no collective runs, and the step is forward,
backward and the optimizer update on one card. A group of more ranks
raises: multi-rank gradient all-reduce comes with ROADMAP Queue 1 item 3.

Metrics leave the step as 0-d device tensors: nothing in the step forces
a host sync; a hook that reads a value pays for it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    LossFn,
    accumulate_grads,
    value_and_grad,
)

def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays or tensors) on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


class DataParallel:
    """Build ``(state, batch) -> (state, metrics)`` train steps and
    ``(state, batch) -> metrics`` eval steps.

    ``device=None`` is the first CUDA card (raises without one);
    ``device="cpu"`` runs the plain versions of the kernels. The state's
    module must already live on that device; batches are moved there.
    """

    def __init__(self, group=None, *, device=None):
        if group is not None:
            import torch.distributed as dist

            if dist.get_world_size(group) > 1:
                raise NotImplementedError(
                    "a process group of more than one rank: ROADMAP Queue 1 "
                    "item 3 (process groups and sync DP)")
        self.group = group
        self.world = 1
        self.device = resolve_device(device)

    def _check(self, state):
        dev = next(state.model.parameters()).device
        if dev != self.device:
            raise ValueError(f"the model lives on {dev}, the step on "
                             f"{self.device}: move it with "
                             f"model.to({str(self.device)!r})")

    def make_train_step(self, loss_fn: LossFn, *, accum_steps: int = 1):
        """``(state, batch) -> (state, {"loss", **metrics})``.

        ``accum_steps > 1`` splits the batch into that many equal
        microbatches and averages their gradients before the one update:
        the full batch's numerics, with activation memory divided by
        ``accum_steps``. The batch length must divide by it.
        """
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

        def step(state, batch):
            self._check(state)
            batch = to_device(batch, self.device)
            if accum_steps == 1:
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
            state = state.apply_gradients(grads)
            return state, {"loss": loss, **mets}

        return step

    def make_eval_step(self, metric_fn: Callable[[torch.nn.Module, Any],
                                                 dict]):
        """``(state, batch) -> metrics``, without gradients."""

        def eval_step(state, batch):
            self._check(state)
            with torch.no_grad():
                return metric_fn(state.model,
                                 to_device(batch, self.device))

        return eval_step
