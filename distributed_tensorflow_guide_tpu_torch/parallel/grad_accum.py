"""Gradients of a loss, whole or accumulated over microbatches.

``loss_fn(module, batch) -> (scalar loss, dict of scalar metrics)``, as
``models/transformer.make_lm_loss_fn`` builds it. Gradients are a dict
``{parameter name: tensor}``: the counterpart of the JAX package's
gradient pytree, keyed like the module's state dict.

While a profiler runs, the forward and the backward of each call are
``forward`` and ``backward`` ranges (``obs/tracing.span``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from distributed_tensorflow_guide_tpu_torch.obs.tracing import span

LossFn = Callable[[torch.nn.Module, Any], tuple[torch.Tensor, dict]]


def value_and_grad(loss_fn: LossFn, module: torch.nn.Module, batch):
    """((loss, metrics), grads) of one call: values detached, grads a dict
    over the parameters that require them. The graph is freed on
    return."""
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    with span(None, "forward"):
        loss, mets = loss_fn(module, batch)
    with span(None, "backward"):
        grads = torch.autograd.grad(loss, [p for _, p in named])
    return ((loss.detach(), {k: v.detach() for k, v in mets.items()}),
            {n: g for (n, _), g in zip(named, grads)})


def accumulate_grads(loss_fn: LossFn, module: torch.nn.Module,
                     microbatches: dict, accum_steps: int):
    """Mean gradient over stacked microbatches, activations freed after
    each one.

    ``microbatches``: a dict whose tensors lead with ``accum_steps``.
    Returns ``(mean_grads, (losses, metrics))``, the losses and each metric
    stacked to shape ``(accum_steps,)``.
    """
    summed: dict[str, torch.Tensor] = {}
    losses, metas = [], []
    for i in range(accum_steps):
        mb = {k: v[i] for k, v in microbatches.items()}
        (loss, mets), g = value_and_grad(loss_fn, module, mb)
        for n, t in g.items():
            if n in summed:
                summed[n] += t
            else:
                summed[n] = t.clone()
        losses.append(loss)
        metas.append(mets)
    stacked = {k: torch.stack([m[k] for m in metas]) for k in metas[0]}
    return ({n: g / accum_steps for n, g in summed.items()},
            (torch.stack(losses), stacked))
