"""What the example scripts share: the device flags, ``--fake-devices`` as
gloo ranks, each rank's share of a global batch, the kernels' launch
counts, and the rank entry that ``runtime/multiprocess`` starts.

Every script has the shape of the JAX package's ``examples/`` twin: an
importable body ``run(args, ...) -> summary dict`` and ``main(argv)``
around it. ``main`` parses the JAX twin's flags plus ``--device``; the
body runs where :func:`device_of` says:

* ``--device cuda`` (the default): this rank's card, raising without one
  (``core/device.resolve_device``); the kernels K1-K6 run there;
* ``--device cpu``: the plain versions of the kernels;
* ``--fake-devices N`` (the JAX package's N virtual CPU devices): N gloo
  ranks on the CPU. ``main`` starts them through
  ``runtime/multiprocess`` with the cards hidden, each rank runs the body
  on its share, and rank 0's output is printed; inside a world that
  ``launch.py`` started, the world is the ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import logging
import os
import sys
import time
from pathlib import Path

import torch

from distributed_tensorflow_guide_tpu_torch.core import dist
from distributed_tensorflow_guide_tpu_torch.core.device import resolve_device
from distributed_tensorflow_guide_tpu_torch.core.mesh import world_and_rank
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as FA
from distributed_tensorflow_guide_tpu_torch.runtime.multiprocess import (
    run_multiprocess,
)
from distributed_tensorflow_guide_tpu_torch.train.hooks import BaseHook

PACKAGE = "distributed_tensorflow_guide_tpu_torch.examples"
# a --fake-devices world's wall-clock limit (seconds)
WORLD_TIMEOUT_S = 3600.0
_RESULT_PREFIX = "DTG_MP_RESULT "


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: this rank's card through the hand-written "
                         "kernels (raises without one); cpu: their plain "
                         "versions")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="N gloo ranks on the CPU (the JAX package's N "
                         "virtual CPU devices); implies --device cpu")


def device_of(args) -> torch.device:
    """The body's device: the CPU when asked for (``--device cpu`` or
    ``--fake-devices``), else this rank's card."""
    if args.fake_devices or args.device == "cpu":
        return resolve_device("cpu")
    return resolve_device(None)


def check_decode_impl(impl: str, device: torch.device) -> None:
    """``--decode-impl``: "auto" and "pallas" are the hand-written decode
    kernels (K5, K6); "dense" is their plain version, which only the CPU
    runs."""
    if impl == "dense" and device.type == "cuda":
        raise ValueError(
            "--decode-impl dense: on a card the port decodes through its "
            "kernels K5/K6 and has no plain path there; use auto or pallas")


def data_share(batch: dict, index: int, size: int, dim: int = 0) -> dict:
    """Rank ``index`` of ``size``'s rows of a global batch along ``dim``
    (the JAX package's ``shard_batch`` over the ``data`` axis)."""
    n = next(iter(batch.values())).shape[dim]
    if n % size:
        raise SystemExit(f"a global batch of {n} does not divide by "
                         f"{size} data ranks")
    per = n // size
    return {k: v[(slice(None),) * dim + (slice(index * per,
                                               (index + 1) * per),)]
            for k, v in batch.items()}


def chief_first(fn):
    """``fn()`` on rank 0, then on the others (one world-wide barrier
    between): for a step that writes a shared file (a tokenizer, a record
    file) which the others then find and read."""
    import torch.distributed as tdist

    ranks, rank = world_and_rank()
    out = fn() if rank == 0 else None
    if ranks > 1:
        tdist.barrier()
    return fn() if rank != 0 else out


def kernel_counts() -> dict[str, int]:
    """The kernels' launch counters, K1-K4 by name and K5/K6 by regime."""
    return {**FA.LAUNCHES, **DA.REGIME_LAUNCHES}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches since ``before`` (a :func:`kernel_counts`), nonzero
    only."""
    return {k: v - before[k] for k, v in kernel_counts().items()
            if v != before[k]}


class LossRecorder(BaseHook):
    """A train-loop hook keeping every step's loss (host floats)."""

    def __init__(self):
        self.losses: list[float] = []

    def after_step(self, step: int, metrics) -> None:
        self.losses.append(float(metrics["loss"]))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Host seconds from construction to :meth:`stop`, which first waits
    for the device."""

    def __init__(self, device: torch.device):
        self.device = device
        sync(device)
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        sync(self.device)
        return time.perf_counter() - self.t0


def module_of(file: str) -> str:
    return f"{PACKAGE}.{Path(file).stem}"


def rank_entry(module: str, argv: list) -> dict:
    """One rank of a script's world (``runtime/multiprocess`` target):
    parse ``argv`` with the script's parser and return its body's
    summary."""
    _log_info()
    mod = importlib.import_module(module)
    return mod.run(mod.parser().parse_args(argv))


def _log_info() -> None:
    # the library's INFO lines (hooks, evaluation) as the JAX twins show
    # them
    logging.basicConfig(level=logging.INFO, format="%(message)s")


@contextlib.contextmanager
def _cards_hidden():
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def main(file: str, argv: list | None = None) -> dict:
    """A script's command line: parse ``argv``, then run the body here, or
    in ``--fake-devices`` gloo ranks on the CPU (printing rank 0's
    output). Returns the body's summary (rank 0's)."""
    _log_info()
    mod = importlib.import_module(module_of(file))
    argv = list(sys.argv[1:] if argv is None else argv)
    args = mod.parser().parse_args(argv)
    n = args.fake_devices
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if n > 1 and ranks == 1:
        with _cards_hidden():
            results = run_multiprocess(rank_entry, n,
                                       [module_of(file), argv],
                                       timeout=WORLD_TIMEOUT_S)
        out = results[0]
        sys.stdout.write("".join(
            ln for ln in out.stdout.splitlines(keepends=True)
            if not ln.startswith(_RESULT_PREFIX)))
        sys.stderr.write(out.stderr)
        sys.stdout.flush()
        return out.result
    if n > 1 and n != ranks:
        raise SystemExit(f"--fake-devices {n} inside a world of {ranks} "
                         "ranks")
    dist.initialize()
    return mod.run(args)
