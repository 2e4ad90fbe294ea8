"""Explicit mixed-precision policy — one object instead of scattered dtypes.

The contract: **params f32 / activations bf16 / loss and accumulation
f32**, plus the selective rematerialisation knob:

* :class:`Policy` — (param_dtype, compute_dtype, accum_dtype, remat),
  where ``remat`` is ``"none"`` (store every intermediate),
  ``"attention"`` (checkpoint only the attention sub-layer) or ``"block"``
  (checkpoint each whole block). ``models/transformer.py`` reads it
  through ``TransformerConfig.remat_mode``.
* :data:`PRESETS`: ``f32``, ``bf16``, ``bf16_remat``, ``bf16_remat_attn``.
* :func:`resolve` takes a preset name, a Policy, or None (the default).

The JAX package's ``int8`` and ``fp8`` presets are not ported yet
(ROADMAP Queue 1 item 9): asking for them by name raises.
"""

from __future__ import annotations

import dataclasses

import torch

REMAT_MODES = ("none", "attention", "block")
_QUANT = "quantised training matmuls are not ported yet: ROADMAP Queue 1 item 9"


@dataclasses.dataclass(frozen=True)
class Policy:
    """One mixed-precision + rematerialisation contract."""

    name: str
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    remat: str = "none"

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"remat must be one of {REMAT_MODES}, got {self.remat!r}")

    def apply_to_transformer(self, cfg):
        """A TransformerConfig under this policy: activation dtype =
        compute_dtype, remat mode = ``remat_mode``."""
        return dataclasses.replace(cfg, dtype=self.compute_dtype,
                                   remat_mode=self.remat)


PRESETS: dict[str, Policy] = {
    # everything f32: the CPU-test / numerics-oracle policy
    "f32": Policy("f32", compute_dtype=torch.float32),
    "bf16": Policy("bf16"),
    # + full-block checkpointing
    "bf16_remat": Policy("bf16_remat", remat="block"),
    # + attention-only checkpointing
    "bf16_remat_attn": Policy("bf16_remat_attn", remat="attention"),
}


def resolve(policy, default: str = "bf16") -> Policy:
    """A Policy from a preset name, a Policy, or None (-> ``default``)."""
    if policy is None:
        policy = default
    if isinstance(policy, Policy):
        return policy
    if str(policy) in ("int8", "fp8"):
        raise NotImplementedError(f"preset {policy!r}: {_QUANT}")
    try:
        return PRESETS[str(policy)]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {policy!r} "
            f"(presets: {sorted(PRESETS)})") from None
