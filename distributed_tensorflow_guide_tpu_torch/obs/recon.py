"""Modeled-vs-measured reconciliation: a cost dict x measured seconds.

Join a step's cost (FLOPs, HBM bytes, collective bytes, host-link
bytes) with a measured duration and report achieved GF/s / GB/s,
per-resource roofline fractions, and which resource the measurement says
the step is bound by.

``reconcile`` duck-types its ``cost`` argument: a dict with the keys
below, or any object with those attributes. Callers pass closed-form
costs computed from a step's shapes (``chip_smoke.py`` does so for one
captured decode step), so the obs package stays stdlib-only at import.

Non-guarantees: the cost vector is the *algorithmic* model (fusion
boundaries, undercounted while-bodies — see docs/analysis.md); the
roofline peaks are whatever the caller supplies. Fractions are evidence
for "where did the time go", not a compiler-grade profile.
"""

from __future__ import annotations

import dataclasses
import math
import os


#: NVIDIA H100 SXM data sheet, dense bf16 tensor-core FLOP/s at 700 W
H100_BF16_FLOPS = 989e12
#: NVIDIA H100 SXM data sheet, HBM3 bytes/s
H100_HBM_BPS = 3.35e12
#: PCIe Gen5 x16, bytes/s each way (the H100 data sheet's 128 GB/s is
#: both directions together)
H100_PCIE_BPS = 64e9


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Peak rates to reconcile against (bytes and flops per second).

    ``from_env`` reads ``DTG_PEAK_FLOPS`` / ``DTG_PEAK_HBM_BPS`` /
    ``DTG_PEAK_ICI_BPS`` / ``DTG_PEAK_PCIE_BPS``, each defaulting to
    the NVIDIA H100 SXM data sheet (dense rates, 700 W): 989e12 bf16
    FLOP/s on the tensor cores, 3.35e12 B/s of HBM3, and 64e9 B/s each
    way over the host's PCIe Gen5 x16 link (the sheet's 128 GB/s counts
    both ways). The card-to-card link has no default: NVLink's 450 GB/s
    each way only where a caller sets ``DTG_PEAK_ICI_BPS``. A card whose
    power limit is below 700 W runs below these peaks.
    """

    peak_flops_s: float
    peak_hbm_bytes_s: float
    peak_ici_bytes_s: float | None = None
    #: host<->device transfer peak (KV spill tier d2h/h2d traffic);
    #: optional like ICI — absent means "don't reconcile swap bytes".
    peak_pcie_bytes_s: float | None = None

    @classmethod
    def from_env(cls) -> "Roofline":
        ici = os.environ.get("DTG_PEAK_ICI_BPS")
        return cls(
            peak_flops_s=float(os.environ.get("DTG_PEAK_FLOPS",
                                              H100_BF16_FLOPS)),
            peak_hbm_bytes_s=float(os.environ.get("DTG_PEAK_HBM_BPS",
                                                  H100_HBM_BPS)),
            peak_ici_bytes_s=float(ici) if ici else None,
            peak_pcie_bytes_s=float(os.environ.get("DTG_PEAK_PCIE_BPS",
                                                   H100_PCIE_BPS)))


def _get(cost, name: str) -> float:
    if isinstance(cost, dict):
        if name == "hbm_bytes" and "hbm_bytes" not in cost:
            return (float(cost.get("hbm_bytes_read", 0.0))
                    + float(cost.get("hbm_bytes_written", 0.0)))
        if name == "collective_bytes_total" and name not in cost:
            cb = cost.get("collective_bytes", {})
            return float(sum(cb.values())) if isinstance(cb, dict) \
                else float(cb or 0.0)
        return float(cost.get(name, 0.0))
    return float(getattr(cost, name))


def reconcile(cost, measured_s: float, roof: Roofline) -> dict:
    """One program execution's modeled-vs-measured reconciliation.

    Returns achieved rates, per-resource roofline fractions, the
    roofline model's predicted time (max over resources), efficiency
    (model time / measured time — 1.0 means the measurement sits ON the
    roofline), and the binding resource."""
    if not (measured_s > 0 and math.isfinite(measured_s)):
        raise ValueError(f"measured_s must be finite > 0, "
                         f"got {measured_s!r}")
    flops = _get(cost, "flops")
    hbm = _get(cost, "hbm_bytes")
    coll = _get(cost, "collective_bytes_total")
    times = {"compute": flops / roof.peak_flops_s,
             "memory": hbm / roof.peak_hbm_bytes_s}
    ici_frac = None
    if roof.peak_ici_bytes_s:
        times["comm"] = coll / roof.peak_ici_bytes_s
        ici_frac = coll / measured_s / roof.peak_ici_bytes_s
    # host-link term: only when the cost dict carries swap/offload bytes
    # AND the roofline has a pcie peak; absent either, the output has no
    # ``pcie_frac`` key.
    pcie_frac = None
    pcie_bytes = (float(cost.get("pcie_bytes", 0.0) or 0.0)
                  if isinstance(cost, dict)
                  else float(getattr(cost, "pcie_bytes", 0.0) or 0.0))
    if roof.peak_pcie_bytes_s and pcie_bytes:
        times["pcie"] = pcie_bytes / roof.peak_pcie_bytes_s
        pcie_frac = pcie_bytes / measured_s / roof.peak_pcie_bytes_s
    model_time_s = max(times.values())
    bound = max(times, key=lambda k: times[k])
    out = {
        "measured_s": measured_s,
        "achieved_gflops_s": flops / measured_s / 1e9,
        "achieved_hbm_gb_s": hbm / measured_s / 1e9,
        "achieved_ici_gb_s": coll / measured_s / 1e9,
        "flops_frac": flops / measured_s / roof.peak_flops_s,
        "hbm_frac": hbm / measured_s / roof.peak_hbm_bytes_s,
        "ici_frac": ici_frac,
        "model_time_s": model_time_s,
        "efficiency": model_time_s / measured_s,
        "bound": bound,
    }
    if pcie_frac is not None:
        out["pcie_frac"] = pcie_frac
    return out
