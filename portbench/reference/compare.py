"""The comparison that decides ``correct``.

Training: the program's first steps (the mix's ``ref_steps``, run
through the window's own call and feed, on the batches the benchmark
drew; for a captured k-step call, two calls: the eager warm-up and the
first replay) against the float32 reference's on the same weights and
batches. Each number has a limit of its own (``limits/<cell>.json``):

* ``loss_gap``: the largest |program - reference| / |reference| over the
  losses of the first ``loss_steps`` compared steps (the mix's; all of
  them where it names none). Adam turns bf16's rounding into whole steps
  of its learning rate, so the later steps' losses drift apart by more
  from seed to seed; their gap is printed beside as ``loss_gap_all``;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient (as its optimizer got it) and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
* ``change_gap``: the same of the norm of each parameter's change over
  the compared steps;
* ``grad_gap_median`` and ``change_gap_median``: the median leaf's gap of
  each, steady from seed to seed where the worst leaf's is not (a small
  leaf whose gradient is a sum that cancels, read in bf16).

A cell compares the numbers its limits file names; the others are
printed beside them.

Leaves whose reference gradient is under a thousandth of the median
leaf's are nought to rounding (a bias under a softmax that cancels it):
they move under Adam by round-off alone and are left out of both gaps.

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the best logit at its position, in one float32 reference
forward over each sampled request's prompt and served tokens.
"""

from __future__ import annotations

import statistics

import torch

TINY_LEAF = 1e-3  # a leaf's gradient under this share of the median's


def _median(xs) -> float:
    return float(statistics.median(xs))


def train_gaps(prog: dict, ref: dict, loss_steps: int | None = None) -> dict:
    """``prog`` and ``ref``: {"losses": [a float a compared step], "grad_norms": {leaf:
    float}, "change_norms": {leaf: float}}."""
    each_loss = [abs(p - r) / abs(r) for p, r in zip(
        prog["losses"], ref["losses"], strict=True)]
    loss_gap = max(each_loss[:loss_steps])
    g_ref = ref["grad_norms"]
    med_g = _median(g_ref.values())
    keep = [n for n, g in g_ref.items() if g >= TINY_LEAF * med_g]
    med_c = _median([ref["change_norms"][n] for n in keep])

    def gaps(a: dict, b: dict, med: float) -> tuple:
        each = sorted((abs(a[n] - b[n]) / max(b[n], med), n) for n in keep)
        gap, name = each[-1]
        return gap, _median(g for g, _ in each), {
            "leaf": name, "program": a[name], "reference": b[name],
            "median_leaf": med}

    grad_gap, grad_med, grad_leaf = gaps(prog["grad_norms"], g_ref, med_g)
    change_gap, change_med, change_leaf = gaps(
        prog["change_norms"], ref["change_norms"], med_c)
    return {"loss_gap": loss_gap, "loss_gap_all": max(each_loss),
            "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_gap_median": grad_med,
            "change_gap_median": change_med, "worst_grad": grad_leaf,
            "worst_change": change_leaf, "losses": {
                "program": prog["losses"], "reference": ref["losses"]},
            "leaves_compared": len(keep), "leaves": len(g_ref)}


def make_optimizer(params: list, spec: dict):
    """The reference's optimizer, from the traffic mix's ``optimizer``."""
    if spec["name"] == "sgd":
        return torch.optim.SGD(params, lr=spec["lr"],
                               momentum=spec.get("momentum", 0.0))
    if spec["name"] == "adam":
        return torch.optim.Adam(params, lr=spec["lr"],
                                betas=tuple(spec["betas"]), eps=spec["eps"])
    raise ValueError(f"unknown optimizer {spec['name']!r}")


def reference_steps(loss_fn, weights: dict, batches: list, opt_spec: dict,
                    steps: int, frozen=None) -> dict:
    """``steps`` optimizer steps of ``loss_fn(weights, batch)`` from
    ``weights`` (float32 leaves, trained in place): the losses, the first
    gradient's norm and each leaf's change after the steps. Leaves that
    ``frozen(name, leaf)`` names stay out of the optimizer: a planted
    fault."""
    w0 = {n: t.detach().clone() for n, t in weights.items()}
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in weights.items()}
    opt = make_optimizer([p for n, p in leaves.items()
                          if not (frozen and frozen(n, p))], opt_spec)
    losses, grad_norms = [], None
    for t in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(leaves, batches[t])
        loss.backward()
        losses.append(float(loss.detach()))
        if t == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(p.grad))
                          for n, p in leaves.items()}
        opt.step()
    change = {n: float(torch.linalg.vector_norm(leaves[n].detach() - w0[n]))
              for n in leaves}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def served_gap(logits: torch.Tensor, prompt_len: int,
               tokens: list) -> float:
    """``logits`` (L, V) of one forward over prompt + served tokens: the
    widest shortfall of a served token's logit below the best at the
    position that produced it."""
    n = len(tokens)
    rows = logits[prompt_len - 1:prompt_len - 1 + n]
    got = rows[torch.arange(n, device=rows.device),
               torch.as_tensor(tokens, device=rows.device)]
    return float((rows.max(dim=-1).values - got).max())


def control_gap(ref_logits: torch.Tensor, low_logits: torch.Tensor,
                prompt_len: int, n: int) -> float:
    """The control's reading: at each position of the same sequence, the
    gap in the reference of the token the lower precision puts first."""
    rows = ref_logits[prompt_len - 1:prompt_len - 1 + n]
    pick = low_logits[prompt_len - 1:prompt_len - 1 + n].argmax(-1)
    got = rows.gather(-1, pick[:, None])[:, 0]
    return float((rows.max(dim=-1).values - got).max())
