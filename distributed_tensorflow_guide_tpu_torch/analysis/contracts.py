"""Declarative program contracts + the global registry.

A :class:`ProgramContract` is what a subsystem *promises* about one of its
entry programs: which collectives it issues on which axes, its precision
policy, which state it updates in place, that it never materialises a
(rows, V) logits tensor, that it never syncs the host. Subsystems expose
their contracts from a ``lint_contracts()`` module function next to the
code they audit; ``analysis.programs`` aggregates them into the registry
the CLI and the tests run over.

The fields and the error words follow the JAX package's contracts; what
changes is what a program is: ``build(device)`` returns ``(fn, args)``,
real tensors (a module's weights, a pool) on ``device``, and the census
(``analysis/walker.py``) is one run of ``fn(*args)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

#: build(device) -> (fn, args): the program and the arguments one run of it
#: takes, made on ``device`` (weights drawn from a numpy seed).
BuildFn = Callable[[Any], tuple[Callable, tuple]]


@dataclasses.dataclass(frozen=True)
class DonationSpec:
    """What the program declares about the state it owns.

    PyTorch has no donation; a donated argument here is state the program
    may consume in place. ``argnums`` are argument positions. ``mode``:

    * ``"alias"`` — every donated leaf is updated in place and read: after
      the call its ``data_ptr`` is the one passed in, some op wrote it,
      and no op made a copy of the whole leaf (the serve engine's pool,
      state -> state).
    * ``"scratch"`` — the buffer is read at least once and never copied
      whole (the one-shot generator's cache, zeroed and refilled each
      call).

    In both modes a donated leaf that is never read is a finding.
    """

    argnums: tuple[int, ...]
    mode: str = "alias"

    def __post_init__(self):
        if self.mode not in ("alias", "scratch"):
            raise ValueError(
                f"donation mode must be 'alias' or 'scratch', "
                f"got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class CostPin:
    """One audited quantity: the cost interpreter's derived number must
    match ``expect`` within ``rel_tol``.

    ``quantity`` is a :meth:`analysis.cost.CostVector.quantity` spelling:
    a scalar field (``"flops"``, ``"hbm_bytes"``, ``"hbm_bytes_read"``,
    ``"hbm_bytes_written"``, ``"peak_live_bytes"``,
    ``"collective_bytes_total"``) or one census-keyed entry spelled
    ``"collective_bytes[psum[data]]"``.

    ``expect`` is a number or a ZERO-ARG CALLABLE evaluated at rule time
    (``lambda: cost.closed_forms().fused_ce_trace_bytes(...)``), so the
    pin IS the closed form. ``rel_tol=0`` means exact.
    """

    quantity: str
    expect: Any
    rel_tol: float = 0.0
    note: str = ""


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """The contract's quantitative promises: closed-form pins plus an
    optional ceiling on peak live bytes (a second copy of the cache or a
    dead donation pushes it up and fails the budget)."""

    pins: tuple[CostPin, ...] = ()
    max_peak_live_bytes: int | None = None


@dataclasses.dataclass(frozen=True)
class ProgramContract:
    """One judged entry program and everything the rules check it against.

    ``collectives`` maps ``"prim[axis,...]"`` census keys (``psum``,
    ``all_gather``, ``reduce_scatter``, ``ppermute``, ...) to an exact
    count or an inclusive ``(lo, hi)`` range of executed calls. With
    ``strict_collectives`` (default) any unlisted collective is a
    violation; an empty dict declares a collective-free program.

    ``policy`` names a ``core/precision.py`` preset (or is a Policy):
    product operands in its compute dtype, large reductions in its accum
    dtype.

    ``vocab_dim`` arms the vocab-materialisation rule: no f32
    (rows >= vocab_rows, ..., vocab_dim) tensor bigger than
    ``max_vocab_f32_elems`` may be allocated anywhere in the run.

    ``allowed_callbacks`` maps host-sync and global-draw spellings
    (``"_local_scalar_dense"``, ``"d2h_copy"``, ``"rand"``, ...) to the
    count, or inclusive ``(lo, hi)`` range, the program may execute.

    ``sources`` lists the module names whose edits should re-trigger this
    contract under ``lint --changed-only``.
    """

    name: str
    build: BuildFn
    policy: Any = "f32"
    collectives: dict[str, Any] | None = None
    strict_collectives: bool = True
    vocab_dim: int | None = None
    vocab_rows: int = 1
    max_vocab_f32_elems: int = 0
    max_f32_intermediate_elems: int | None = None
    donation: DonationSpec | None = None
    allowed_callbacks: dict[str, Any] = dataclasses.field(
        default_factory=dict)
    sources: tuple[str, ...] = ()
    notes: str = ""
    #: quantitative promises; None = observe-only (the cost vector is
    #: still derived and fingerprinted, just not pinned)
    cost: CostSpec | None = None
    #: opt-in for integer products: int8 operands only, an int32 result,
    #: rescaled by an f32 scale downstream. Default False: an integer
    #: product in any other program is a finding.
    quantized_matmuls: bool = False
    #: opt-in for fp8 products: e4m3fn operands only, accumulated in the
    #: policy's accum dtype, rescaled by an f32 scale downstream.
    fp8_matmuls: bool = False


_REGISTRY: dict[str, ProgramContract] = {}


def register(contract: ProgramContract) -> ProgramContract:
    """Add one contract to the global registry (re-registering a name
    replaces it, so provider modules can be re-imported)."""
    _REGISTRY[contract.name] = contract
    return contract


def registered_contracts(
    names: tuple[str, ...] | list[str] | None = None,
) -> list[ProgramContract]:
    """Registry contents in registration order. ``names`` filters; an
    unknown name is an error, not an empty result."""
    if names is None:
        return list(_REGISTRY.values())
    unknown = [n for n in names if n not in _REGISTRY]
    if unknown:
        raise KeyError(
            f"unknown program(s) {unknown}; registered: "
            f"{sorted(_REGISTRY)}")
    return [_REGISTRY[n] for n in names]


def clear_registry() -> None:
    """Test isolation hook."""
    _REGISTRY.clear()
