"""Build the package's CUDA kernels with ``nvcc`` and load them via ctypes.

Every ``.cu`` source under ``ops/csrc/`` is compiled for Hopper
(``sm_90a``) into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes), the first time
a kernel is asked for. The sources share the headers ``csrc/*.cuh``.
Libraries are named by the hash of their source, the headers and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.
They go to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``); ``DTG_TORCH_BUILD_DIR`` overrides the location. ptxas's
report of each kernel (registers, spills) is kept beside its library and
read back by :func:`ptxas_usage`.

Nothing here runs at import: the CPU test suite imports every module,
on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("DTG_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source on the machine with the card")


def source_digest(name: str) -> str:
    """The cache key of ``csrc/<name>.cu``'s library: a hash of the source,
    of every header under ``csrc/`` (sources include them, so an edited
    header must rebuild) and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    return src, build_dir() / f"lib{name}_{source_digest(name)[:16]}.so"


def _compile(name: str) -> Path:
    src, out = _target(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".ptxas").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_usage(name: str) -> tuple[dict[str, dict], list[str]]:
    """ptxas's report for the built ``csrc/<name>.cu``: mangled kernel
    name -> {"registers", "spill_stores", "spill_loads"} (bytes), and
    ptxas's warning lines."""
    _, out = _target(name)
    usage: dict[str, dict] = {}
    warnings, fn = [], None
    for line in out.with_suffix(".ptxas").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            usage[fn] = {}
        elif "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and fn in usage:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            usage[fn]["spill_stores"], usage[fn]["spill_loads"] = nums[1:3]
        elif "Used" in line and "registers" in line and fn in usage:
            usage[fn]["registers"] = int(line.split("Used")[1].split()[0])
        elif "warning" in line.lower():
            warnings.append(line.strip())
    return usage, warnings


def build_all() -> dict[str, Path]:
    """Compile every source under ``csrc/`` at once, one ``nvcc`` each,
    all started together. Returns name -> library path."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        paths = list(ex.map(_compile, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _LIBS[name] = lib
        return lib
