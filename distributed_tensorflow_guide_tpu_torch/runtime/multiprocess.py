"""Run a function in N real processes, one rank each, and supervise them.

The counterpart of the JAX package's ``MultiProcessRunner`` (itself TF's
``multi_process_runner``): every process gets the environment of
``core/dist.py`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), joins the process
group, runs a ``"module:function"`` target and hands back its
JSON-serialisable result. Arrays in a result dict (numpy arrays or
tensors) travel through one ``.npz`` file per rank, not through the JSON
line, and come back as numpy arrays.

The runner supervises: per-process exit codes, captured stdout and stderr,
a wall-clock timeout, and the moment one rank fails the others get a grace
period (a peer blocked in a collective on the dead rank never finishes) and
are then killed. The bootstrap imports only torch, numpy and this package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Sequence

_RESULT_SENTINEL = "DTG_MP_RESULT "
_ROOT = Path(__file__).resolve().parents[2]

_BOOTSTRAP = r"""
import importlib, json, os
spec = json.loads(os.environ["DTG_MP_SPEC"])
from distributed_tensorflow_guide_tpu_torch.core import dist
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess
dist.initialize()
mod, _, fn = spec["target"].rpartition(":")
result = getattr(importlib.import_module(mod), fn)(*spec["args"])
multiprocess.emit_result(result, spec["out_dir"])
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def emit_result(result: Any, out_dir: str) -> None:
    """Print this rank's result line; arrays of a dict result go to
    ``out_dir/rank{RANK}.npz`` and are named in the line."""
    import numpy as np
    import torch

    rank = int(os.environ.get("RANK", "0"))
    if isinstance(result, dict):
        arrays = {k: (v.detach().cpu().numpy()
                      if isinstance(v, torch.Tensor) else v)
                  for k, v in result.items()
                  if isinstance(v, (np.ndarray, torch.Tensor))}
        if arrays:
            np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)
            result = {k: v for k, v in result.items() if k not in arrays}
            result["__npz__"] = sorted(arrays)
    print(_RESULT_SENTINEL + json.dumps(result), flush=True)


def supervise(
    procs: Sequence[subprocess.Popen],
    *,
    timeout: float,
    failure_grace: float,
    on_first_failure: Callable[[int, int], None] | None = None,
) -> bool:
    """Poll the processes until all exit, the first failure's grace period
    expires, or the deadline hits; then kill and reap any that are left.
    ``on_first_failure(rank, code)`` fires once, at the first nonzero exit.
    Returns True iff the deadline was hit."""
    deadline = time.monotonic() + timeout
    fail_deadline = None
    timed_out = False
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        now = time.monotonic()
        if fail_deadline is None and any(c not in (None, 0) for c in codes):
            if on_first_failure is not None:
                bad = next(i for i, c in enumerate(codes)
                           if c not in (None, 0))
                on_first_failure(bad, codes[bad])
            fail_deadline = now + failure_grace
        if now >= deadline:
            timed_out = True
            break
        if fail_deadline is not None and now >= fail_deadline:
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return timed_out


def rank_env(rank: int, world: int, port: int,
             extra: dict[str, str] | None = None) -> dict[str, str]:
    """The environment of one rank on this host."""
    env = dict(os.environ)
    env.update(extra or {})
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
               RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH")) if p)
    # N ranks on one host share its cores
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // world)))
    return env


@dataclasses.dataclass
class ProcessResult:
    rank: int
    returncode: int | None  # None: killed before it exited
    stdout: str
    stderr: str
    result: Any = None  # the target's return value, if it finished

    @property
    def ok(self) -> bool:
        return self.returncode == 0


class MultiProcessError(RuntimeError):
    def __init__(self, msg: str, results: list[ProcessResult]):
        super().__init__(msg)
        self.results = results


class MultiProcessRunner:
    """Run ``target`` in ``num_processes`` ranks.

    ``target``: a module-level function (or ``"pkg.mod:fn"``) taking the
    JSON-serialisable ``args`` and returning a JSON-serialisable value or a
    dict holding arrays. Each rank joins the process group with
    ``dist.initialize()``'s rule: NCCL when every rank has a card of its
    own, else gloo.
    """

    def __init__(self, target: Callable | str, num_processes: int,
                 args: Sequence[Any] = (), *, timeout: float = 180.0):
        if callable(target):
            if ("." in target.__qualname__
                    or target.__module__ == "__main__"):
                raise ValueError(
                    "target must be a module-level function importable as "
                    f"'pkg.mod:fn', got {target.__module__}:"
                    f"{target.__qualname__}")
            target = f"{target.__module__}:{target.__qualname__}"
        self.target = target
        self.num_processes = num_processes
        self.args = list(args)
        self.timeout = timeout
        self._procs: list[subprocess.Popen] = []
        self._files: list[tuple[Any, Any]] = []
        self._tmp = None

    def start(self) -> "MultiProcessRunner":
        port = free_port()
        self._tmp = tempfile.TemporaryDirectory(prefix="dtg_torch_mp_")
        spec = json.dumps({"target": self.target, "args": self.args,
                           "out_dir": self._tmp.name})
        for rank in range(self.num_processes):
            env = rank_env(rank, self.num_processes, port)
            env["DTG_MP_SPEC"] = spec
            out = open(Path(self._tmp.name) / f"out_{rank}.txt", "w+")
            err = open(Path(self._tmp.name) / f"err_{rank}.txt", "w+")
            self._files.append((out, err))
            self._procs.append(subprocess.Popen(
                [sys.executable, "-c", _BOOTSTRAP], env=env, stdout=out,
                stderr=err, cwd=os.getcwd()))
        return self

    def _collect(self, rank: int, proc, out, err) -> ProcessResult:
        import numpy as np

        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        value = None
        for line in stdout.splitlines():
            if line.startswith(_RESULT_SENTINEL):
                value = json.loads(line[len(_RESULT_SENTINEL):])
        if isinstance(value, dict) and "__npz__" in value:
            with np.load(Path(self._tmp.name) / f"rank{rank}.npz") as z:
                value.update({k: z[k] for k in value.pop("__npz__")})
        return ProcessResult(rank, proc.returncode, stdout, stderr, value)

    def kill(self, rank: int) -> None:
        """SIGKILL one rank (no barriers, no atexit: a real crash); the
        others see it through :meth:`join`'s failure grace."""
        self._procs[rank].kill()

    def join(self, raise_on_error: bool = True, *,
             failure_grace: float = 10.0) -> list[ProcessResult]:
        """Supervise until every rank exits, the deadline hits, or a
        failure's grace period ends (a peer blocked on a dead rank is
        killed then); then collect each rank's output. Raises
        :class:`MultiProcessError` unless every rank exited 0 (with
        ``raise_on_error=False`` the results come back either way)."""
        timed_out = supervise(self._procs, timeout=self.timeout,
                              failure_grace=failure_grace)
        results = [self._collect(r, p, out, err) for r, (p, (out, err))
                   in enumerate(zip(self._procs, self._files))]
        self._tmp.cleanup()
        self._procs, self._files = [], []
        if raise_on_error and (timed_out or any(not r.ok for r in results)):
            bad = [r for r in results if not r.ok]
            detail = "\n".join(
                f"--- rank {r.rank} (exit {r.returncode}) ---\n"
                f"{r.stderr[-3000:]}" for r in bad)
            raise MultiProcessError(
                f"{'timeout; ' if timed_out else ''}"
                f"{len(bad)}/{len(results)} ranks failed:\n{detail}",
                results)
        return results


def run_multiprocess(target: Callable | str, num_processes: int,
                     args: Sequence[Any] = (), **kw) -> list[ProcessResult]:
    """One call: start, join, raise on any rank's failure."""
    return MultiProcessRunner(target, num_processes, args,
                              **kw).start().join()
