"""Registry population: import every provider, register every contract.

Each subsystem that ships a judged entry program exposes a module-level
``lint_contracts() -> list[ProgramContract]`` next to the code it audits
(the contract lives WITH the program, not in a central manifest). This
module is the one aggregation point: importing it (which
``lint._registered`` does for its side effect) registers everything.

Provider failures are deliberately NOT swallowed: a provider that cannot
even build its contract list is a lint failure in its own right.

The twelve programs registered here run in one process and issue no
collective: the serving engine's steps, the one-shot generator's decode,
the fused cross-entropy and the fp8 training product.
"""

from __future__ import annotations

import importlib

from distributed_tensorflow_guide_tpu_torch.analysis.contracts import register

PROVIDER_MODULES = (
    "distributed_tensorflow_guide_tpu_torch.ops.fused_ce",
    "distributed_tensorflow_guide_tpu_torch.ops.quant",
    "distributed_tensorflow_guide_tpu_torch.models.generation",
    "distributed_tensorflow_guide_tpu_torch.serve.engine",
)


def load_all() -> None:
    for mod_name in PROVIDER_MODULES:
        mod = importlib.import_module(mod_name)
        for contract in mod.lint_contracts():
            register(contract)


load_all()
