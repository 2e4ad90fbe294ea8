"""``python -m distributed_tensorflow_guide_tpu_torch.launch`` — start N
identical processes of one command on this host and supervise them.

There are no roles: every process runs the same script and differs only
in ``RANK``. The launcher sets the environment ``core/dist.py`` reads
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), prefixes every output line of
process k with ``[p{k}]``, and supervises: at the first nonzero exit the
others get a grace period and are then killed, and the launcher's exit
code says so.

Usage::

    python -m distributed_tensorflow_guide_tpu_torch.launch \\
        --num-processes 4 --device cpu script.py --steps 10

``--device cpu`` hides the cards from the processes
(``CUDA_VISIBLE_DEVICES=""``), so they join over gloo and an entry point
must be given ``device="cpu"``; ``--device cuda`` leaves them visible
(rank k's ``device=None`` is ``cuda:{k % cards}``). The script calls
``core.dist.initialize()`` and ``core.mesh.build_mesh(...)``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import threading

from distributed_tensorflow_guide_tpu_torch.runtime.multiprocess import (
    free_port,
    rank_env,
    supervise,
)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_tensorflow_guide_tpu_torch.launch",
        description="Start and supervise N ranks of one command on this "
                    "host.")
    p.add_argument("--num-processes", "-n", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu hides the cards from the processes")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="wall-clock limit of the whole run (seconds)")
    p.add_argument("--failure-grace", type=float, default=10.0,
                   help="seconds the others get after the first failure")
    p.add_argument("--port", type=int, default=0,
                   help="MASTER_PORT; 0 picks a free one")
    p.add_argument("target", help="script path")
    p.add_argument("args", nargs=argparse.REMAINDER,
                   help="arguments handed to the target")
    return p


def _stream(proc: subprocess.Popen, rank: int,
            lock: threading.Lock) -> None:
    """Copy one process's output to ours with a [p{k}] prefix."""
    for raw in proc.stdout:
        line = raw.decode("utf-8", "replace")
        with lock:
            sys.stdout.write(f"[p{rank}] {line}")
            sys.stdout.flush()


def main(argv: list[str] | None = None) -> int:
    ns = _parser().parse_args(argv)
    if ns.args and ns.args[0] == "--":
        ns.args = ns.args[1:]
    port = ns.port or free_port()
    cmd = [sys.executable, ns.target] + ns.args
    extra = {"CUDA_VISIBLE_DEVICES": ""} if ns.device == "cpu" else {}
    print(f"launch: {ns.num_processes} processes, master localhost:{port}, "
          f"cmd: {' '.join(cmd)}", flush=True)

    def announce(rank: int, code: int) -> None:
        print(f"launch: process {rank} exited {code}; the others get "
              f"{ns.failure_grace:.0f}s", file=sys.stderr, flush=True)

    procs, threads = [], []
    lock = threading.Lock()
    timed_out = False
    try:
        for rank in range(ns.num_processes):
            proc = subprocess.Popen(
                cmd, env=rank_env(rank, ns.num_processes, port, extra),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            procs.append(proc)
            t = threading.Thread(target=_stream, args=(proc, rank, lock),
                                 daemon=True)
            t.start()
            threads.append(t)
        timed_out = supervise(procs, timeout=ns.timeout,
                              failure_grace=ns.failure_grace,
                              on_first_failure=announce)
        if timed_out:
            print("launch: timeout; killed all", file=sys.stderr,
                  flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in threads:
            t.join(timeout=5.0)
    codes = [p.returncode for p in procs]
    print(f"launch: exit codes {codes}" + (" (timeout)" if timed_out
                                           else ""), flush=True)
    return 0 if not timed_out and all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
