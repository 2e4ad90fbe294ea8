"""Golden program fingerprints: the drift gate over registered programs.

A fingerprint is two things per registered program:

* ``structure`` — sha256 of the rendered census (``walker.render``: one
  line per executed op or kernel node, storages renumbered in order of
  first appearance, addresses normalised), so the hash moves exactly
  when the program's structure moves — a new op, a changed shape or
  dtype, another dataflow — and never with the process's addresses.
* ``cost`` — the derived :class:`analysis.cost.CostVector`, rounded, so a
  pure cost-model change is ALSO a gated change.

Goldens persist to ``analysis/golden_fingerprints.json`` next to this
module: committed, sorted, one program an entry, the bless ``reason``
stored inline. They are the CPU census under the torch of the machine
that blessed them; on the card the hashes are printed, not gated (the
card runs other ops: a host-to-device copy of the step's inputs, the
kernels' own dtype overloads). A program whose fingerprint differs from
its golden, or a registered program with no golden, fails the lint until
``lint --bless --reason "why"`` rewrites the file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

from distributed_tensorflow_guide_tpu_torch.analysis import walker

GOLDEN_PATH = Path(__file__).resolve().parent / "golden_fingerprints.json"

#: cost entries are rounded to this many decimals before storing, so float
#: formatting can never flap the gate
_ROUND = 3


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    program: str
    structure: str  # sha256 hex of the rendered census
    cost: dict  # rounded CostVector.to_dict()

    def to_json(self) -> dict:
        return {"structure": self.structure, "cost": self.cost}


def _round(value):
    if isinstance(value, dict):
        return {k: _round(v) for k, v in sorted(value.items())}
    if isinstance(value, float):
        return round(value, _ROUND)
    return value


def structure_hash(census) -> str:
    """Stable hash of the rendered census."""
    return hashlib.sha256(walker.render(census).encode()).hexdigest()


def fingerprint(name: str, census, cost_vector) -> Fingerprint:
    return Fingerprint(program=name, structure=structure_hash(census),
                       cost=_round(cost_vector.to_dict()))


# ---- golden store ---------------------------------------------------------------


def load_goldens(path: Path | None = None) -> dict:
    """{program: {"structure", "cost", "reason"}}; empty when no golden
    file exists (every program then reports a missing golden)."""
    p = path or GOLDEN_PATH
    if not Path(p).exists():
        return {}
    return json.loads(Path(p).read_text())


def save_goldens(fingerprints: list[Fingerprint], reason: str,
                 path: Path | None = None) -> Path:
    """Bless: rewrite the golden file from live fingerprints, ``reason``
    stored per program."""
    p = Path(path or GOLDEN_PATH)
    payload = {
        fp.program: {**fp.to_json(), "reason": reason}
        for fp in sorted(fingerprints, key=lambda f: f.program)
    }
    p.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return p


def diff_fingerprint(fp: Fingerprint, goldens: dict) -> list[str]:
    """Human-readable drift lines for one program; [] when clean."""
    gold = goldens.get(fp.program)
    if gold is None:
        return [f"{fp.program}: no golden fingerprint "
                f"(new program? bless it with --bless --reason)"]
    out = []
    if gold.get("structure") != fp.structure:
        out.append(f"{fp.program}: structure hash drifted "
                   f"{gold.get('structure', '?')[:12]} -> "
                   f"{fp.structure[:12]}")
    gcost, lcost = gold.get("cost", {}), fp.cost
    for key in sorted(set(gcost) | set(lcost)):
        if key == "collective_bytes":
            g, live = gcost.get(key, {}), lcost.get(key, {})
            for ck in sorted(set(g) | set(live)):
                if g.get(ck) != live.get(ck):
                    out.append(f"{fp.program}: cost[{key}[{ck}]] "
                               f"{g.get(ck)} -> {live.get(ck)}")
        elif gcost.get(key) != lcost.get(key):
            out.append(f"{fp.program}: cost[{key}] "
                       f"{gcost.get(key)} -> {lcost.get(key)}")
    return out


def stale_goldens(live_names: set[str], goldens: dict) -> list[str]:
    """Goldens of programs that no longer exist (renamed or removed
    without a bless): the registry and the record must agree."""
    return [f"{name}: golden exists but program is not registered "
            f"(removed/renamed? re-bless)"
            for name in sorted(set(goldens) - live_names)]


def census_diff(a, b, limit: int = 12) -> list[str]:
    """The rendered lines of census ``a`` that ``b`` lacks (``-``) and
    those ``b`` adds (``+``), as a multiset, at most ``limit`` of each: how
    two runs of one program differ (the card's census against the
    CPU's)."""
    from collections import Counter

    def lines(c):
        def sig(ms):
            return ", ".join(f"{walker._dt(m.dtype)}{list(m.shape)}"
                             for m in ms)
        return Counter(f"{n.name}({sig(n.inputs)}) -> ({sig(n.outputs)})"
                       for n in c.nodes)

    la, lb = lines(a), lines(b)
    minus = [f"- {k} x{v}" for k, v in sorted((la - lb).items())]
    plus = [f"+ {k} x{v}" for k, v in sorted((lb - la).items())]
    return minus[:limit] + plus[:limit]
