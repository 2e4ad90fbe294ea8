"""The train state: a module, its optimizer and the step count.

The counterpart of flax's ``TrainState``. The JAX package's optimizers are
optax transforms; here they are ``torch.optim`` optimizers over the
module's parameters:

* ``optax.adam(lr)`` is ``torch.optim.Adam(params, lr, betas=(0.9, 0.999),
  eps=1e-8, weight_decay=0)``. Both keep m and v, correct each by
  ``1 - beta ** t`` and step by ``lr * m_hat / (sqrt(v_hat) + eps)``
  (optax's ``eps_root`` is 0);
* ``optax.sgd(lr)`` is ``torch.optim.SGD(params, lr)``, and
  ``optax.sgd(lr, momentum=0.9)`` is ``torch.optim.SGD(params, lr,
  momentum=0.9)``: both keep ``v = g + 0.9 v`` and step by ``-lr * v``;
* ``optax.adamw(lr)`` is ``torch.optim.AdamW(params, lr,
  weight_decay=1e-4)``: optax decays at 1e-4 by default, torch at 1e-2,
  so the decay is passed; the decoupled decay is then the same algebra.

BatchNorm's running statistics are module buffers, so a model with them
needs no other state here (the JAX package's ``TrainStateWithStats``).

Unlike flax's, :meth:`TrainState.apply_gradients` updates the parameters
in place and returns the same object: one copy of the weights and of the
optimizer moments lives on the card, which is what the JAX package gets
from buffer donation.

A captured train step (``steps_per_call``, ``core/graphs.MultiStep``)
replays this update from a CUDA graph. The gradients it assigns are then
tensors of the graph's private pool, whose addresses the capture fixed,
so every replay writes and reads them where the capture did; the
optimizer must keep its step counter and its bias corrections on the card:
``torch.optim.Adam(..., capturable=True)`` / ``AdamW(..., capturable=
True)`` (SGD has no counter; its momentum buffer is made by the first
call's eager run). A learning rate that a schedule moves between calls
must be a device tensor written in place (``lr=torch.tensor(1e-3,
device="cuda")``); at ``steps_per_call > 1`` such a schedule is refused.
``step`` moves by k a call.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from distributed_tensorflow_guide_tpu_torch.obs.tracing import span


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer step with ``grads`` ({parameter name: tensor},
        as ``parallel/grad_accum.value_and_grad`` gives them); an
        ``optimizer`` range while a profiler runs."""
        with span(None, "optimizer"):
            for name, p in self.model.named_parameters():
                if p.requires_grad:
                    p.grad = grads[name]
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self
