"""The program auditor: declarative contracts over the port's entry
programs, checked against a census of what each program executes.

Each judged entry point registers a :class:`~.contracts.ProgramContract`
from a ``lint_contracts()`` function beside its code, and ``python -m
distributed_tensorflow_guide_tpu_torch.analysis.lint`` runs every
registered program once under the census recorder (``walker.py``) and
audits it with five rule families (memory, precision, collectives,
in-place state, determinism) and a cost audit (``cost.py``) held to
golden fingerprints (``fingerprint.py``). The auditor observes programs;
it never rewrites them.

Import discipline: torch only; nothing here imports the JAX package.
"""

from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (  # noqa: F401
    CostPin,
    CostSpec,
    DonationSpec,
    ProgramContract,
    register,
    registered_contracts,
)
