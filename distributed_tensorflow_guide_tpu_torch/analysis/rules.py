"""The five rule families the linter runs over every program's census,
plus the cost audit.

Each rule is a pure function ``(traced, contract) -> RuleReport``: it reads
the census (never changes the program), records what it OBSERVED, so a
passing report is still evidence, and emits a :class:`Finding` per
violation with the expected/observed pair the report renders as a diff.
The JAX package's families, with the meaning each has in PyTorch:

1. **memory** — the largest f32 tensor the program allocated stays under
   its cap, and no f32 (rows >= n, ..., V) tensor is allocated (the
   fused-CE "no full logits" pin).
2. **precision** — the factors of ``mm`` / ``addmm`` / ``bmm`` /
   ``baddbmm`` / ``convolution`` are in the policy's compute dtype. A
   product whose factors were ALL widened from one narrower dtype is a
   product in that dtype (the CPU spells a bf16 product that accumulates
   in f32 as ``a.float() @ b.float()``; the card as ``torch.mm(a, b,
   out_dtype=f32)``; both pass under ``bf16``). Reductions (``sum``,
   ``mean``, ``_softmax``, ``_log_softmax``, ``logsumexp``,
   ``var_mean``) over at least :data:`ACCUM_MIN_REDUCED` elements return
   the accum dtype. Integer products (``_int_mm``, or int8-widened
   factors) need ``quantized_matmuls``, int8 factors, an int32 result and
   an f32 scale on a consumer; fp8 products (``_scaled_mm``, or the CPU
   emulation's e4m3-widened factors) need ``fp8_matmuls`` and e4m3fn
   factors, the accum dtype out and an f32 scale on a consumer. A product
   with only SOME factors widened (a weight-only dequantised kernel
   against an f32 activation) counts at the widened dtype.
3. **collectives** — the executed-call census equals the contract,
   strictly; an empty dict means collective-free. A ``c10d`` op issued
   around ``collectives.py`` is a finding of its own.
4. **donation** — PyTorch has no donation; see
   ``contracts.DonationSpec`` for what ``alias`` and ``scratch`` mean
   here. A donated leaf that is never read is a finding.
5. **determinism** — a host sync (``_local_scalar_dense``: ``.item()``,
   ``int(t)``, ``bool(t)``; a ``_to_copy`` / ``copy_`` from a CUDA tensor
   to the CPU, spelled ``d2h_copy``) or a draw from the global generator
   (``uniform_``, ``normal_``, ``bernoulli_``, ``rand``, ``randint``,
   ``multinomial``, ...) is a finding unless ``allowed_callbacks`` lists
   it with its count. The port samples with threefry from explicit keys.
   On the CPU ``.cpu().numpy()`` dispatches nothing: that blind spot is
   closed only by running the program on the card.
6. **cost** — the derived :class:`~.cost.CostVector` against the
   contract's :class:`~.contracts.CostSpec`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from distributed_tensorflow_guide_tpu_torch.analysis import walker
from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
    ProgramContract,
)
from distributed_tensorflow_guide_tpu_torch.analysis.cost import (
    PRODUCTS,
    product_operands,
)


@dataclasses.dataclass
class Finding:
    """One violation: ``expected`` vs ``observed`` renders as the diff."""

    rule: str
    message: str
    expected: Any = None
    observed: Any = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RuleReport:
    rule: str
    observed: dict
    findings: list[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {"rule": self.rule, "ok": self.ok, "observed": self.observed,
                "findings": [f.to_dict() for f in self.findings]}


@dataclasses.dataclass
class TracedProgram:
    """A contract's program after one recorded run."""

    name: str
    census: walker.Census
    #: set by rule_cost, so the linter fingerprints without a second pass
    cost_vector: Any = None


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _range(want) -> tuple[int, int]:
    return want if isinstance(want, tuple) else (want, want)


# ---- 1. memory ------------------------------------------------------------------


def rule_memory(traced: TracedProgram,
                contract: ProgramContract) -> RuleReport:
    elems, shape = walker.largest_f32_intermediate(traced.census)
    observed = {"largest_f32_elems": elems, "largest_f32_shape": list(shape)}
    findings = []
    cap = contract.max_f32_intermediate_elems
    if cap is not None and elems > cap:
        findings.append(Finding(
            "memory",
            f"largest f32 intermediate {shape} has {elems} elements, over "
            f"the declared cap",
            expected=f"<= {cap} elements", observed=elems))
    if contract.vocab_dim is not None:
        worst = walker.max_f32_elems_with_vocab_dim(
            traced.census, contract.vocab_rows, contract.vocab_dim)
        observed["vocab_materialized_elems"] = worst
        if worst > contract.max_vocab_f32_elems:
            findings.append(Finding(
                "memory",
                f"f32 (rows>={contract.vocab_rows}, ..., "
                f"V={contract.vocab_dim}) logits-shaped intermediate "
                "materialized",
                expected=f"<= {contract.max_vocab_f32_elems} elements",
                observed=worst))
    return RuleReport("memory", observed, findings)


# ---- 2. precision ---------------------------------------------------------------

#: Reductions at or above this many reduced elements must accumulate in the
#: policy's accum dtype; smaller ones are bookkeeping, not a hazard.
ACCUM_MIN_REDUCED = 64

REDUCTIONS = frozenset({"sum", "mean", "_softmax", "_log_softmax",
                        "logsumexp", "var_mean"})
_FP8 = torch.float8_e4m3fn
_FP8_ALL = frozenset({torch.float8_e4m3fn, torch.float8_e5m2})
#: ops a product's result may pass through on its way to the dequant mul
_CHAIN = frozenset({"_to_copy", "view", "_unsafe_view", "reshape", "slice",
                    "expand", "t", "transpose", "clone", "contiguous",
                    "alias"})


def _factor_dtypes(census, node) -> list[torch.dtype]:
    """The dtypes a product multiplies: each factor's own, or, when every
    factor was widened from one narrower dtype, that dtype."""
    factors = product_operands(node)
    origins = [census.origin.get(m.sid) for m in factors]
    if all(o is not None for o in origins) and len(set(origins)) == 1:
        return origins
    return [m.dtype for m in factors]


def _dequant_ok(census, node) -> bool:
    """Does the product's result reach a ``mul`` by an f32 tensor, through
    a short chain of converts and views (``acc.float() * scale``)."""
    sids = {m.sid for m in node.outputs}
    for later in census.nodes[node.index + 1:]:
        hit = [m for m in later.inputs if m.sid in sids]
        if not hit:
            continue
        if later.name == "mul":
            if any(m.sid not in sids and m.dtype == torch.float32
                   for m in later.inputs):
                return True
        elif later.name in _CHAIN:
            sids |= {m.sid for m in later.outputs}
    return False


def _reduced(node) -> int:
    src, out = node.inputs[0], node.outputs[0]
    if node.name in ("_softmax", "_log_softmax"):
        dim = node.attrs.get("dim", -1)
        return src.shape[dim] if src.shape else 1
    return max(1, src.numel) // max(1, out.numel)


def rule_precision(traced: TracedProgram,
                   contract: ProgramContract) -> RuleReport:
    from distributed_tensorflow_guide_tpu_torch.core import precision

    census = traced.census
    policy = precision.resolve(contract.policy)
    compute, accum = policy.compute_dtype, policy.accum_dtype
    observed: dict = {"policy": policy.name, "matmuls": 0,
                      "bad_operand_matmuls": 0, "bad_accum_ops": 0,
                      "int_matmuls": 0, "fp8_matmuls": 0}
    findings = []
    for node in census.nodes:
        if node.kind != "op":
            continue
        name = node.name
        if name in PRODUCTS:
            observed["matmuls"] += 1
            dts = _factor_dtypes(census, node)
            out = node.outputs[0].dtype
            ints = sorted({_dt(d) for d in dts if not d.is_floating_point})
            fp8 = sorted({_dt(d) for d in dts if d in _FP8_ALL})
            if ints:
                observed["int_matmuls"] += 1
                if not contract.quantized_matmuls:
                    findings.append(Finding(
                        "precision",
                        f"{name} with integer operands {ints} in a program "
                        "whose contract does not opt in via "
                        "quantized_matmuls",
                        expected="float operands (or "
                                 "contract.quantized_matmuls=True)",
                        observed=ints))
                elif set(dts) != {torch.int8}:
                    findings.append(Finding(
                        "precision",
                        f"quantized {name} operands must be int8, got "
                        f"{sorted(_dt(d) for d in dts)}",
                        expected="int8",
                        observed=sorted(_dt(d) for d in dts)))
                elif out != torch.int32:
                    findings.append(Finding(
                        "precision",
                        f"quantized {name} accumulates in {_dt(out)}: int8 "
                        "products must sum in int32",
                        expected="int32", observed=_dt(out)))
                elif not _dequant_ok(census, node):
                    findings.append(Finding(
                        "precision",
                        f"quantized {name} result is never rescaled by an "
                        "f32 scale (no dequant mul found on its "
                        "accumulator)",
                        expected="acc.float() * f32_scale",
                        observed="no f32 mul in the consumer chain"))
                continue
            if fp8:
                observed["fp8_matmuls"] += 1
                if not contract.fp8_matmuls:
                    findings.append(Finding(
                        "precision",
                        f"{name} with fp8 operands {fp8} in a program "
                        "whose contract does not opt in via fp8_matmuls",
                        expected="policy-dtype operands (or "
                                 "contract.fp8_matmuls=True)",
                        observed=fp8))
                elif set(dts) != {_FP8}:
                    findings.append(Finding(
                        "precision",
                        f"fp8 {name} operands must all be float8_e4m3fn, "
                        f"got {sorted(_dt(d) for d in dts)}",
                        expected="float8_e4m3fn",
                        observed=sorted(_dt(d) for d in dts)))
                elif out != accum:
                    findings.append(Finding(
                        "precision",
                        f"fp8 {name} accumulates in {_dt(out)}: fp8 "
                        "products must return the accum dtype",
                        expected=_dt(accum), observed=_dt(out)))
                elif not _dequant_ok(census, node):
                    findings.append(Finding(
                        "precision",
                        f"fp8 {name} result is never rescaled by an f32 "
                        "scale (no dequant mul found on its accumulator)",
                        expected="acc * f32_scale",
                        observed="no f32 mul in the consumer chain"))
                continue
            bad = sorted({_dt(d) for d in dts} - {_dt(compute)})
            if bad:
                observed["bad_operand_matmuls"] += 1
                findings.append(Finding(
                    "precision",
                    f"{name} operands in {bad} violate the {policy.name} "
                    "policy's compute dtype",
                    expected=_dt(compute), observed=bad))
        elif name in REDUCTIONS and node.inputs and node.outputs:
            out = node.outputs[0].dtype
            if not out.is_floating_point:
                continue
            reduced = _reduced(node)
            if reduced >= ACCUM_MIN_REDUCED and out != accum:
                observed["bad_accum_ops"] += 1
                findings.append(Finding(
                    "precision",
                    f"{name} over {reduced} elements accumulates in "
                    f"{_dt(out)}",
                    expected=_dt(accum), observed=_dt(out)))
    return RuleReport("precision", observed, findings)


# ---- 3. collectives ---------------------------------------------------------------


def rule_collectives(traced: TracedProgram,
                     contract: ProgramContract) -> RuleReport:
    census = walker.collective_census(traced.census)
    bypass = len(traced.census.bypass)
    observed = {"census": dict(sorted(census.items())),
                "bypassing_ops": bypass}
    findings = []
    if bypass:
        findings.append(Finding(
            "collectives",
            f"{bypass} c10d op(s) issued around collectives.py (a "
            "collective the trace cannot see)",
            expected="every collective through collectives.py",
            observed=bypass))
    if contract.collectives is None:  # census-only program: observe, allow
        return RuleReport("collectives", observed, findings)
    for key, want in sorted(contract.collectives.items()):
        got = census.get(key, 0)
        lo, hi = _range(want)
        if not lo <= got <= hi:
            findings.append(Finding(
                "collectives",
                f"{key}: expected "
                + (f"{lo}" if lo == hi else f"{lo}..{hi}")
                + f", traced {got}",
                expected=want, observed=got))
    if contract.strict_collectives:
        for key in sorted(set(census) - set(contract.collectives)):
            findings.append(Finding(
                "collectives",
                f"undeclared collective {key} x{census[key]} in the trace "
                "(stray communication)",
                expected="absent", observed=census[key]))
    return RuleReport("collectives", observed, findings)


# ---- 4. donation ------------------------------------------------------------------


def rule_donation(traced: TracedProgram,
                  contract: ProgramContract) -> RuleReport:
    spec = contract.donation
    if spec is None:
        return RuleReport("donation", {"declared": None}, [])
    census = traced.census
    observed = {"declared": list(spec.argnums), "mode": spec.mode}
    findings = []
    reads = {s for n in census.nodes for s in n.reads}
    writes = {s for n in census.nodes for s in n.writes}
    donated: list[tuple[int, walker.TensorMeta]] = []
    for argnum in spec.argnums:
        if argnum >= len(census.arg_metas):
            findings.append(Finding(
                "donation", f"donate argnum {argnum} out of range",
                expected=f"< {len(census.arg_metas)} args",
                observed=argnum))
            continue
        donated += [(argnum, m) for m in census.arg_metas[argnum]]
    copies = 0
    for argnum, m in donated:
        leaf = f"arg {argnum} leaf {_dt(m.dtype)}{list(m.shape)}"
        if m.sid not in reads:
            findings.append(Finding(
                "donation",
                f"donated buffer ({leaf}) is never read — dead donation",
                expected="buffer read at least once", observed="unused"))
        whole = [n for n in census.nodes
                 if any(i.sid == m.sid and i.numel >= m.numel
                        for i in n.inputs)
                 and any(o.sid in n.new and o.numel >= m.numel
                         for o in n.outputs)]
        if whole:
            copies += len(whole)
            findings.append(Finding(
                "donation",
                f"donated buffer ({leaf}) copied whole by "
                f"{sorted({n.name for n in whole})}",
                expected="updated in place, never copied",
                observed=len(whole)))
        if spec.mode == "alias" and m.sid not in writes:
            findings.append(Finding(
                "donation",
                f"donated buffer ({leaf}) is never updated in place",
                expected="an in-place write", observed="not written"))
    if spec.mode == "alias":
        moved = sum(
            a != b for argnum in spec.argnums
            if argnum < len(census.arg_ptrs_before)
            for a, b in zip(census.arg_ptrs_before[argnum],
                            census.arg_ptrs_after[argnum]))
        observed["moved_leaves"] = moved
        if moved:
            findings.append(Finding(
                "donation",
                f"{moved} donated leaf/leaves hold another buffer after the "
                "call (replaced, not updated in place)",
                expected="the data_ptr passed in", observed=moved))
    observed["donated_leaves"] = len(donated)
    observed["whole_copies"] = copies
    return RuleReport("donation", observed, findings)


# ---- 5. determinism ---------------------------------------------------------------

#: spellings of a host sync
HOST_SYNCS = frozenset({"_local_scalar_dense", "d2h_copy"})


def determinism_hits(census: walker.Census) -> dict[str, int]:
    """Host syncs and global-generator draws the run executed, by
    spelling."""
    hits: dict[str, int] = {}
    for n in census.nodes:
        if n.kind != "op":
            continue
        key = None
        if n.name == "_local_scalar_dense":
            key = n.name
        elif n.name in ("_to_copy", "copy_") and n.inputs and n.outputs:
            src = n.inputs[1] if n.name == "copy_" else n.inputs[0]
            dst = n.inputs[0] if n.name == "copy_" else n.outputs[0]
            if src.device == "cuda" and dst.device == "cpu":
                key = "d2h_copy"
        elif n.name in walker.RANDOM_OPS and n.attrs.get("global_generator"):
            key = n.name
        if key is not None:
            hits[key] = hits.get(key, 0) + 1
    return hits


def rule_determinism(traced: TracedProgram,
                     contract: ProgramContract) -> RuleReport:
    hits = determinism_hits(traced.census)
    observed = {"hits": hits}
    findings = []
    for name, count in sorted(hits.items()):
        what = ("host sync" if name in HOST_SYNCS
                else "global-generator draw")
        want = contract.allowed_callbacks.get(name)
        if want is None:
            findings.append(Finding(
                "determinism",
                f"{what} {name} x{count} inside the step function",
                expected="absent", observed=count))
            continue
        lo, hi = _range(want)
        if not lo <= count <= hi:
            findings.append(Finding(
                "determinism",
                f"{what} {name} x{count}, allowed "
                + (f"{lo}" if lo == hi else f"{lo}..{hi}"),
                expected=want, observed=count))
    return RuleReport("determinism", observed, findings)


# ---- 6. cost ------------------------------------------------------------------------


def rule_cost(traced: TracedProgram,
              contract: ProgramContract) -> RuleReport:
    """Derive the program's cost vector and hold it to the contract's
    :class:`~.contracts.CostSpec`. With no spec the rule is observe-only
    (the vector still feeds the fingerprint gate)."""
    from distributed_tensorflow_guide_tpu_torch.analysis import cost as cm

    spec = contract.cost
    try:
        vec = cm.program_cost(traced, contract)
    except Exception as e:
        findings = [] if spec is None else [Finding(
            "cost", f"cost interpreter failed on the census: {e!r}",
            expected="interpretable census", observed=type(e).__name__)]
        return RuleReport("cost", {"error": repr(e)}, findings)
    traced.cost_vector = vec
    observed = vec.to_dict()
    if spec is None:
        return RuleReport("cost", observed, [])
    findings = []
    for pin in spec.pins:
        want = float(pin.expect() if callable(pin.expect) else pin.expect)
        got = vec.quantity(pin.quantity)
        if abs(got - want) > pin.rel_tol * max(abs(want), 1.0):
            findings.append(Finding(
                "cost",
                f"{pin.quantity} drifted from the closed-form model"
                + (f" ({pin.note})" if pin.note else ""),
                expected=(f"{want:g}" if pin.rel_tol == 0
                          else f"{want:g} ±{pin.rel_tol:.1%}"),
                observed=got))
    cap = spec.max_peak_live_bytes
    if cap is not None and vec.peak_live_bytes > cap:
        findings.append(Finding(
            "cost",
            f"peak live bytes {vec.peak_live_bytes} over the declared "
            "budget",
            expected=f"<= {cap} bytes", observed=vec.peak_live_bytes))
    return RuleReport("cost", observed, findings)


#: The rules the linter runs, in report order.
ALL_RULES: tuple[Callable[[TracedProgram, ProgramContract], RuleReport],
                 ...] = (
    rule_memory,
    rule_precision,
    rule_collectives,
    rule_donation,
    rule_determinism,
    rule_cost,
)

