"""Explicit mixed-precision policy — one object instead of scattered dtypes.

The contract: **params f32 / activations bf16 / loss and accumulation
f32**, plus the selective rematerialisation knob:

* :class:`Policy` — (param_dtype, compute_dtype, accum_dtype, remat),
  where ``remat`` is ``"none"`` (store every intermediate),
  ``"attention"`` (checkpoint only the attention sub-layer) or ``"block"``
  (checkpoint each whole block). ``models/transformer.py`` reads it
  through ``TransformerConfig.remat_mode``.
* :data:`PRESETS`: ``f32``, ``bf16``, ``bf16_remat``, ``bf16_remat_attn``,
  and the quantised training presets ``int8`` and ``fp8``: f32 masters
  and f32 compute around projections whose products run through
  ``ops/quant.int8_ste_dot`` / ``fp8_ste_dot`` (``quantized_matmuls`` /
  ``fp8_matmuls``), so the quantiser is the only change from ``f32``.
* :func:`resolve` takes a preset name, a Policy, or None (the default).
* The fp8 gate: :func:`fp8_capable` / :func:`require_fp8`. The reference
  keys it on TPU generations; here it is a CUDA card of compute
  capability 9.0 or more (Hopper's e4m3 tensor-core products), or
  :data:`FP8_EMULATE_ENV` set for numerics work elsewhere.
"""

from __future__ import annotations

import dataclasses
import os

import torch

REMAT_MODES = ("none", "attention", "block")


@dataclasses.dataclass(frozen=True)
class Policy:
    """One mixed-precision + rematerialisation contract."""

    name: str
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    remat: str = "none"
    # int8 / fp8 training products (ops/quant.int8_ste_dot, fp8_ste_dot)
    quantized_matmuls: bool = False
    fp8_matmuls: bool = False

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"remat must be one of {REMAT_MODES}, got {self.remat!r}")
        if self.quantized_matmuls and self.fp8_matmuls:
            raise ValueError(
                "quantized_matmuls and fp8_matmuls are exclusive — one "
                "quantized representation per policy")

    def apply_to_transformer(self, cfg):
        """A TransformerConfig under this policy: activation dtype =
        compute_dtype, remat mode = ``remat_mode``, the int8 / fp8
        training products."""
        return dataclasses.replace(
            cfg, dtype=self.compute_dtype, remat_mode=self.remat,
            quantized_matmuls=self.quantized_matmuls,
            fp8_matmuls=self.fp8_matmuls)


PRESETS: dict[str, Policy] = {
    # everything f32: the CPU-test / numerics-oracle policy
    "f32": Policy("f32", compute_dtype=torch.float32),
    "bf16": Policy("bf16"),
    # + full-block checkpointing
    "bf16_remat": Policy("bf16_remat", remat="block"),
    # + attention-only checkpointing
    "bf16_remat_attn": Policy("bf16_remat_attn", remat="attention"),
    # int8 / fp8 training products around f32 compute: the only change
    # from "f32" is the quantiser
    "int8": Policy("int8", compute_dtype=torch.float32,
                   quantized_matmuls=True),
    "fp8": Policy("fp8", compute_dtype=torch.float32, fp8_matmuls=True),
}


def resolve(policy, default: str = "bf16") -> Policy:
    """A Policy from a preset name, a Policy, or None (-> ``default``)."""
    if policy is None:
        policy = default
    if isinstance(policy, Policy):
        return policy
    try:
        return PRESETS[str(policy)]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {policy!r} "
            f"(presets: {sorted(PRESETS)})") from None


#: Set truthy to make :func:`fp8_capable` say yes anywhere: numerics work
#: where the (slow) emulated semantics are the point.
FP8_EMULATE_ENV = "DTG_FP8_EMULATE"
#: The least CUDA compute capability with e4m3 tensor-core products.
FP8_MIN_CAPABILITY = (9, 0)


def _device_kind(device) -> tuple[str, tuple[int, int] | None]:
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return dev.type, None
    return (torch.cuda.get_device_name(dev),
            torch.cuda.get_device_capability(dev))


def fp8_capable(device=None) -> bool:
    """Whether ``device`` (default ``cuda:0``) multiplies e4m3 natively:
    a CUDA card of compute capability >= 9.0. With
    :data:`FP8_EMULATE_ENV` set truthy, always True."""
    raw = os.environ.get(FP8_EMULATE_ENV, "").strip().lower()
    if raw not in ("", "0", "false", "no", "off"):
        return True
    _, cap = _device_kind(device)
    return cap is not None and cap >= FP8_MIN_CAPABILITY


def require_fp8(device=None) -> None:
    """Raise ``ValueError`` when fp8 is asked for on a device without
    native e4m3 products: emulated fp8 reads as many bytes as f32 and
    does more work, the opposite of what the preset is for."""
    if fp8_capable(device):
        return
    kind, cap = _device_kind(device)
    raise ValueError(
        f"fp8 requested but {kind!r} (compute capability {cap}) has no "
        "native fp8 matmul mode (a CUDA card of compute capability >= "
        f"{FP8_MIN_CAPABILITY[0]}.{FP8_MIN_CAPABILITY[1]} has). Use "
        "precision 'bf16'/'int8' (or weight_dtype='int8' for decode) "
        f"here, or set {FP8_EMULATE_ENV}=1 to force the emulation for "
        "numerics work.")
