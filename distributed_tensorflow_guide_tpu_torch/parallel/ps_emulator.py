"""Host-side emulation of true async parameter-server semantics.

The strategies of ``parallel/async_ps.py`` are synchronous by
construction. This module keeps the reference's actual semantics (stale
parameter reads, interleaved writes, per-worker pacing) so that tests can
measure the difference.

One event is one worker micro-step; the order of events is a seeded
pseudorandom schedule (``numpy.random.RandomState(seed).randint``, the
JAX package's, so a seed gives the same order in both packages):

* ``hogwild``: the worker reads the PS's current parameters, takes a
  gradient and applies it to the PS at once (SGD; ``fetch_period`` is 1);
* ``downpour``: the worker trains a local replica, and every
  ``fetch_period`` of its events pushes its accumulated parameter delta
  to the PS and pulls fresh parameters;
* ``adag``: the worker accumulates raw gradients on stale parameters;
  every ``fetch_period`` events it pushes their mean, and the PS applies
  an adaptive optimizer (``torch.optim.Adam`` over the PS tensors by
  default, the JAX package's ``optax.adam(lr)``; ``train/state.py`` gives
  the mapping).

The parameter server's state (its parameters, the workers' replicas and
accumulators, the optimizer) lives on the host; the gradients run on the
module's device.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    to_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
    LossFn,
    value_and_grad,
)

Params = dict[str, torch.Tensor]


def _zeros(p: Params) -> Params:
    return {n: torch.zeros_like(t) for n, t in p.items()}


class AsyncPSEmulator:
    """``loss_fn(module, batch) -> (loss, metrics)``; ``module`` holds the
    initial parameters and computes every gradient, on ``device``
    (``None``: this rank's CUDA card, raising without one; ``"cpu"``).
    ``make_optimizer(params)`` builds ADAG's PS optimizer over the PS's
    tensors (default ``torch.optim.Adam(params, lr)``)."""

    def __init__(self, loss_fn: LossFn, module: torch.nn.Module, *,
                 n_workers: int, mode: str = "hogwild", lr: float = 0.1,
                 fetch_period: int = 1,
                 make_optimizer: Callable | None = None, seed: int = 0,
                 device=None):
        if mode not in ("hogwild", "downpour", "adag"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        dev = next(module.parameters()).device
        if dev != self.device:
            raise ValueError(f"the module lives on {dev}, the emulator's "
                             f"gradients on {self.device}")
        self.loss_fn = loss_fn
        self.module = module
        self.mode = mode
        self.lr = lr
        self.fetch_period = 1 if mode == "hogwild" else fetch_period
        self.n_workers = n_workers
        self.ps_params: Params = {n: p.detach().cpu().clone()
                                  for n, p in module.named_parameters()}
        self._rng = np.random.RandomState(seed)
        if mode == "adag":
            make = make_optimizer or (
                lambda ps: torch.optim.Adam(ps, lr=lr))
            self.optimizer = make(list(self.ps_params.values()))
        # per-worker local replicas (copies: ADAG's optimizer updates the
        # PS's tensors in place), accumulators and event counts
        self.local = [{n: p.clone() for n, p in self.ps_params.items()}
                      for _ in range(n_workers)]
        self.accum = [_zeros(self.ps_params) for _ in range(n_workers)]
        self.events = [0] * n_workers
        self.pushes = 0

    def _grad(self, params: Params, batch) -> tuple[float, Params]:
        """The loss and the gradients at ``params`` (host tensors), run on
        the module's device; gradients back on the host."""
        with torch.no_grad():
            for n, p in self.module.named_parameters():
                p.copy_(params[n])
        (loss, _), g = value_and_grad(self.loss_fn, self.module,
                                      to_device(batch, self.device))
        return loss.item(), {n: t.cpu() for n, t in g.items()}

    # -- PS ops --------------------------------------------------------------

    def _push_pull(self, k: int) -> None:
        """Worker ``k`` pushes its accumulated delta or gradients and
        pulls fresh parameters."""
        self.pushes += 1
        if self.mode == "adag":
            for n, p in self.ps_params.items():
                p.grad = self.accum[k][n] / self.fetch_period
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.local[k] = {n: p.clone() for n, p in
                             self.ps_params.items()}
        else:
            self.ps_params = {n: p + self.accum[k][n]
                              for n, p in self.ps_params.items()}
            self.local[k] = self.ps_params
        self.accum[k] = _zeros(self.accum[k])

    def _event(self, k: int, batch) -> float:
        """One micro-step of worker ``k``."""
        if self.mode == "hogwild":
            # a fresh read of the PS's parameters and a racing write back:
            # staleness comes only from the interleaving of events
            loss, g = self._grad(self.ps_params, batch)
            self.accum[k] = {n: -self.lr * t for n, t in g.items()}
            self._push_pull(k)
            return loss
        loss, g = self._grad(self.local[k], batch)
        if self.mode == "downpour":
            delta = {n: -self.lr * t for n, t in g.items()}
            self.local[k] = {n: p + delta[n]
                             for n, p in self.local[k].items()}
            self.accum[k] = {n: a + delta[n]
                             for n, a in self.accum[k].items()}
        else:  # adag: raw gradients at stale parameters
            self.accum[k] = {n: a + g[n] for n, a in self.accum[k].items()}
        self.events[k] += 1
        if self.events[k] % self.fetch_period == 0:
            self._push_pull(k)
        return loss

    def run(self, data: Iterator, n_events: int) -> list[float]:
        """Interleave ``n_events`` worker micro-steps in the seeded
        order; the loss of each."""
        losses = []
        for _ in range(n_events):
            k = int(self._rng.randint(self.n_workers))
            losses.append(self._event(k, next(data)))
        return losses
