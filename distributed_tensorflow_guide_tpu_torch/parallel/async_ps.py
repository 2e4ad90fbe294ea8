"""Async parameter-server training, re-thought for a synchronous fabric.

The reference's main subject is async PS training through
``tf.train.replica_device_setter`` in three flavours: Hogwild (lock-free
writes to PS-resident parameters), DOWNPOUR (``fetch_period`` local steps,
then push the update and pull fresh parameters) and ADAG (workers push
gradients, the PS applies an adaptive optimizer). The JAX package keeps
what these buy (less communication a step, tolerance of divergent local
state) and replaces the mechanism with collectives:

* Hogwild -> :class:`GossipSGD`: each replica updates locally, then mixes
  its parameters with its two ring neighbours (two ``ring_shift`` hops);
* DOWNPOUR -> :class:`LocalSGD`: ``sync_period`` local optimizer steps,
  then one ``pmean`` of the parameters and the float optimizer moments;
* ADAG -> :class:`AccumulatedAdaptive`: gradients accumulated over
  ``accum_steps`` sub-batches, one ``pmean``, one adaptive update.

Here a replica is a process with its own module and optimizer (a
``TrainState``), so nothing carries the JAX package's leading world axis:
:meth:`GossipSGD.distribute` is the identity. The exact asynchronous
semantics live on the host in ``parallel/ps_emulator.py``.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    to_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    LossFn,
    accumulate_grads,
    value_and_grad,
)


def _float_moments(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's floating state tensors by (parameter index, key):
    ``exp_avg``, ``exp_avg_sq``, ``momentum_buffer``. torch keeps Adam's
    ``step`` as a float tensor; it is the same on every replica and stays
    out (optax's int count, which the JAX package's pmean skips)."""
    out = {}
    for i, st in enumerate(optimizer.state.values()):
        for k, t in st.items():
            if k != "step" and isinstance(t, torch.Tensor) and (
                    t.is_floating_point()):
                out[f"{i}.{k}"] = t
    return out


class _Strategy:
    def __init__(self, mesh: Mesh, axis: str = "data", *, device=None):
        self.mesh = mesh
        self.axis = axis
        self.world = mesh.axis(axis).size
        self.device = resolve_device(device)

    def _pmean(self, x):
        return cc.pmean(x, self.axis, mesh=self.mesh)


class LocalSGD(_Strategy):
    """DOWNPOUR on a synchronous fabric: ``sync_period`` local optimizer
    steps on this replica's stream, then one ``pmean`` of the parameters
    and one of the float optimizer moments. With ``sync_period=1`` and
    plain SGD this is sync DP.

    The step takes a batch whose tensors lead with ``(sync_period,
    per_replica_batch, ...)``.
    """

    def __init__(self, mesh: Mesh, sync_period: int, axis: str = "data", *,
                 device=None):
        super().__init__(mesh, axis, device=device)
        if sync_period < 1:
            raise ValueError(f"sync_period must be >= 1, got {sync_period}")
        self.sync_period = sync_period

    def make_train_step(self, loss_fn: LossFn):
        """``(state, batches) -> (state, {"loss"})``; ``state.step``
        counts local steps."""

        def step(state, batches):
            batches = to_device(batches, self.device)
            losses = []
            for i in range(self.sync_period):
                (loss, _), g = value_and_grad(
                    loss_fn, state.model, {k: v[i] for k, v in
                                           batches.items()})
                state = state.apply_gradients(g)
                losses.append(loss)
            # the "push the update, pull fresh parameters" collective
            params = dict(state.model.named_parameters())
            moments = _float_moments(state.optimizer)
            with torch.no_grad():
                for tree in (params, moments):
                    if tree:
                        for n, t in self._pmean(tree).items():
                            tree[n].copy_(t)
            return state, {"loss": self._pmean(torch.stack(losses).mean())}

        return step


class GossipSGD(_Strategy):
    """Hogwild's bounded-staleness sibling: a local step, then mixing with
    the two ring neighbours, ``p <- (1 - mix) p + mix / 2 (left +
    right)``. Information crosses the ring in ``world / 2`` steps; the
    replicas genuinely differ between them (at two ranks left and right
    are the same rank: run it at four or more).
    """

    def __init__(self, mesh: Mesh, axis: str = "data", mix: float = 0.5, *,
                 device=None):
        super().__init__(mesh, axis, device=device)
        self.mix = mix

    def distribute(self, state):
        """The identity: every rank already holds its own replica."""
        return state

    def make_train_step(self, loss_fn: LossFn):
        """``(state, batch) -> (state, {"loss"})``: the local update, then
        one hop each way around the ring (each rank's parameters in one
        flat buffer a hop)."""

        def step(state, batch):
            batch = to_device(batch, self.device)
            (loss, _), g = value_and_grad(loss_fn, state.model, batch)
            state = state.apply_gradients(g)  # purely local
            params = list(state.model.parameters())
            with torch.no_grad():
                flat = torch.cat([p.reshape(-1) for p in params])
                left = cc.ring_shift(flat, self.axis, shift=1,
                                     mesh=self.mesh)
                right = cc.ring_shift(flat, self.axis, shift=-1,
                                      mesh=self.mesh)
                mixed = (1.0 - self.mix) * flat + (self.mix / 2.0) * (
                    left + right)
                for p, part in zip(params, mixed.split(
                        [p.numel() for p in params])):
                    p.copy_(part.view_as(p))
            return state, {"loss": self._pmean(loss)}

        return step

    def consensus(self, state) -> dict[str, torch.Tensor]:
        """The mean of the replicas' parameters (for evaluation and
        checkpoints), on every rank."""
        return self._pmean({n: p.detach() for n, p in
                            state.model.named_parameters()})


class AccumulatedAdaptive(_Strategy):
    """ADAG on a synchronous fabric: gradients accumulated over
    ``accum_steps`` sub-batches without an update, one ``pmean``, one
    adaptive update everywhere (the PS's Adam, replicated).

    The step takes a batch whose tensors lead with ``(accum_steps,
    per_replica_batch, ...)``.
    """

    def __init__(self, mesh: Mesh, accum_steps: int, axis: str = "data", *,
                 device=None):
        super().__init__(mesh, axis, device=device)
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.accum_steps = accum_steps

    def make_train_step(self, loss_fn: LossFn):
        """``(state, batches) -> (state, {"loss"})``."""

        def step(state, batches):
            batches = to_device(batches, self.device)
            g, (losses, _) = accumulate_grads(loss_fn, state.model, batches,
                                              self.accum_steps)
            state = state.apply_gradients(self._pmean(g))
            return state, {"loss": self._pmean(losses.mean())}

        return step
