"""flax's default initialisers, drawn with a ``torch.Generator``.

The port's models draw random weights from a seed on their own device;
these give them the distributions the JAX package's modules start from
(not the same numbers: the generators differ).
"""

from __future__ import annotations

import math

import torch

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
_CDF_LO = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
_CDF_HI = 0.5 * (1 + math.erf(2 / math.sqrt(2)))


def lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in`` (by the inverse CDF)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = _CDF_LO + (_CDF_HI - _CDF_LO) * u
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


def generator_for(module: torch.nn.Module, seed: int) -> torch.Generator:
    """A generator on the device of ``module``'s parameters."""
    dev = next(module.parameters()).device
    return torch.Generator(device=dev).manual_seed(seed)
