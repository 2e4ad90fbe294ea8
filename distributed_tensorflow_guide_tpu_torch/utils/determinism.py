"""Determinism checker — the SPMD answer to race detection.

The JAX package's ``utils/determinism.py``, on the port's ``MeshSpec``.

The reference has no race detection; its Hogwild example (⚠ Hogwild/hogwild.py)
*is* a deliberate data race — lock-free `apply_gradients` on shared PS
variables, correctness-by-robustness (SURVEY.md §5 race-detection row). In
SPMD-sync land races are impossible by construction, so the useful invariant
flips: **the same seed must produce the same numbers — across runs and across
mesh topologies**. A violation means nondeterministic collectives, stray host
RNG, or a topology-dependent reduction order leaking into the math.

Two checks:

* :func:`check_runs` — run the same training function twice with the same
  seed; metrics must match bit-for-bit (sync SPMD has no excuse for drift).
* :func:`check_topologies` — run under different MeshSpecs; metrics must
  match within ``rtol`` (reduction orders legitimately differ across mesh
  shapes, so exact equality is not required — this mirrors SURVEY.md §4's
  "within tolerance" tier).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

from distributed_tensorflow_guide_tpu_torch.core.mesh import MeshSpec

Metrics = Mapping[str, float]


@dataclasses.dataclass
class DeterminismReport:
    ok: bool
    max_abs_diff: float
    max_rel_diff: float
    detail: str

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise AssertionError(f"determinism check failed: {self.detail}")


def _flatten(ms: Sequence[Metrics]) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for step_metrics in ms:
        for k, v in step_metrics.items():
            out.setdefault(k, []).append(float(v))
    return out


def _compare(a: Sequence[Metrics], b: Sequence[Metrics], rtol: float,
             label: str) -> DeterminismReport:
    fa, fb = _flatten(a), _flatten(b)
    if fa.keys() != fb.keys():
        return DeterminismReport(False, math.inf, math.inf,
                                 f"{label}: metric keys differ: "
                                 f"{sorted(fa)} vs {sorted(fb)}")
    max_abs = max_rel = 0.0
    for k in fa:
        if len(fa[k]) != len(fb[k]):
            return DeterminismReport(False, math.inf, math.inf,
                                     f"{label}: {k} has {len(fa[k])} vs "
                                     f"{len(fb[k])} entries")
        for x, y in zip(fa[k], fb[k]):
            if math.isnan(x) and math.isnan(y):
                continue
            if math.isnan(x) or math.isnan(y):
                # one-sided NaN is the classic nondeterministic-divergence
                # symptom; Python max() would silently drop a NaN diff
                return DeterminismReport(
                    False, math.inf, math.inf,
                    f"{label}: {k} diverged to NaN in one run only "
                    f"({x} vs {y})")
            ad = abs(x - y)
            rd = ad / max(abs(x), abs(y), 1e-12)
            max_abs, max_rel = max(max_abs, ad), max(max_rel, rd)
    ok = max_rel <= rtol
    return DeterminismReport(
        ok, max_abs, max_rel,
        f"{label}: max_abs_diff={max_abs:.3g} max_rel_diff={max_rel:.3g} "
        f"(rtol={rtol:g})",
    )


def check_runs(train: Callable[[int], Sequence[Metrics]], *, seed: int = 0,
               runs: int = 2, rtol: float = 0.0) -> DeterminismReport:
    """``train(seed)`` returns per-step metrics; all ``runs`` invocations with
    the SAME seed must agree (default: bit-for-bit, rtol=0)."""
    ref = train(seed)
    worst = DeterminismReport(True, 0.0, 0.0, "single run")
    for i in range(1, runs):
        rep = _compare(ref, train(seed), rtol, f"run 0 vs run {i} (seed {seed})")
        if rep.max_rel_diff >= worst.max_rel_diff:
            worst = rep
        if not rep.ok:
            return rep
    return worst


def check_topologies(
    train: Callable[[MeshSpec, int], Sequence[Metrics]],
    specs: Sequence[MeshSpec], *, seed: int = 0, rtol: float = 1e-5,
) -> DeterminismReport:
    """``train(mesh_spec, seed)`` must produce matching metrics for every
    spec in ``specs`` — same global batch, different shardings."""
    if len(specs) < 2:
        raise ValueError("need at least two MeshSpecs to compare")
    ref = train(specs[0], seed)
    worst = DeterminismReport(True, 0.0, 0.0, "single topology")
    for spec in specs[1:]:
        rep = _compare(ref, train(spec, seed), rtol,
                       f"{specs[0]} vs {spec} (seed {seed})")
        if rep.max_rel_diff >= worst.max_rel_diff:
            worst = rep
        if not rep.ok:
            return rep
    return worst
