"""Device resolution: the one place the port decides where it runs.

Every entry point (``ServeEngine``, ``make_generate_fn``, the serve CLI)
takes ``device=None`` and hands it here. ``None`` means
the first CUDA card; a machine without one raises instead of carrying on
on the CPU, so a run that was meant for the card can never quietly
measure the host. Callers that want the CPU (the parity tests) say so
with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises when no card is present); anything
    else is taken as the caller's explicit choice and validated."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
