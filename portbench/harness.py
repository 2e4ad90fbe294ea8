"""What every cell of the benchmark shares: finding a cell's files by
name, the environment a run keeps to, the device's description, the
profiler slice and its reduction, and the result line.

Nothing here imports JAX or the JAX package; the port
(``distributed_tensorflow_guide_tpu_torch``) is imported only by the
runners, inside the functions that run a cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "distributed_tensorflow_guide_tpu")


class CellError(RuntimeError):
    """A cell that cannot run here (no card, a missing file)."""


# ---- finding a cell's files by name -------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, its traffic mix and its
    limits, each read from the file its name gives."""
    spec = benchmark_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    bench = root / HERE.name
    mix = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name])]
    return {"cell": cell, "config": config, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer}


def load_module(path: Path, name: str):
    """A module from its file (metric files carry dots in their names)."""
    mod_name = "portbench_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise CellError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(mix: dict, root: Path = ROOT):
    """The runner module the traffic mix names."""
    name = mix["runner"]
    return load_module(root / HERE.name / "runners" / f"{name}.py",
                       "runner_" + name)


def read_layer_metrics(per_layer: list, run: dict,
                       root: Path = ROOT) -> dict:
    """Each per-layer metric from its own reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in per_layer:
        reader = load_module(root / HERE.name / "metrics"
                             / f"{m['name']}.py", "metric_" + m["name"])
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---- the environment of a run ---------------------------------------------


def fix_environment(root: Path = ROOT) -> None:
    """Every cache the program or its libraries keep goes to a fixed
    directory inside the checkout, so the first run of a cell builds and
    later runs find it built. Set before torch is imported."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    # the port's nvcc and g++ builds: build/kernels, build/native
    os.environ.pop("DTG_TORCH_BUILD_DIR", None)
    # the tuning table's defaults, the same on both sides of a check: a
    # table path nothing writes, and no online sweep
    os.environ["DTG_AUTOTUNE_TABLE"] = str(build / "portbench"
                                           / "no_tuning_table.json")
    os.environ["DTG_ONLINE_TUNE"] = "0"


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that a run may not hold, each
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def require_cards(n: int):
    """The card count a cell asks for, or a CellError: no fallback."""
    import torch

    if not torch.cuda.is_available():
        raise CellError("torch.cuda.is_available() is false: this cell "
                        "runs on an NVIDIA card")
    if torch.cuda.device_count() < n:
        raise CellError(f"the cell asks for {n} cards, "
                        f"{torch.cuda.device_count()} present")
    return torch.device("cuda:0")


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(dev, count: int) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    dev)),
                "power_limit_w": power_limit_w()}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0, "power_limit_w": None}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---- weights from the seed ------------------------------------------------


def seeded_weights(specs: dict, seed: int, dev) -> dict:
    """{name: tensor} drawn from ``seed`` on ``dev`` in one call: a flat
    standard normal, each leaf a slice of it scaled and shifted by its
    spec ``(shape, std, mean)``. The same seed on the same device gives
    the same bits, so the reference draws the weights again itself."""
    import torch

    total = sum(_numel(s[0]) for s in specs.values())
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    out, off = {}, 0
    for name, (shape, std, mean) in specs.items():
        n = _numel(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# ---- the profiler slice ---------------------------------------------------


class TraceSlice:
    """``torch.profiler`` over a slice of the run, inside a host span that
    ends with a synchronize, so the span covers the slice's device work.
    :meth:`reduce` gives the device's busy seconds in the span, the
    span's length, each kernel name's count and seconds, and the longest
    idle gaps by the host op that spanned them."""

    SPAN = "portbench.trace_slice"

    def __init__(self, dev):
        import torch

        self.dev = dev
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._span = None

    def __enter__(self):
        import torch

        sync(self.dev)
        self.prof.__enter__()
        self._span = torch.profiler.record_function(self.SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        sync(self.dev)
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.SPAN)


def _kernel_name(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    for stop in ("<", "("):
        i = base.find(stop)
        if i > 0:
            base = base[:i]
    return base.strip()


def reduce_events(events, span_name: str) -> dict:
    """The trace of a slice, reduced: device busy seconds inside the span
    (the union of every device operation's interval), the span's length,
    ``kernels`` {short name: [count, seconds]}, the top device ops, and
    the ten longest idle gaps named by the innermost host op that
    covers each gap's middle."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    span = None
    dev_iv, host = [], []
    kernels: dict = {}
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if name == span_name or getattr(
                    e, "is_user_annotation", lambda: False)():
                continue  # a host span's mirror on the device timeline
            dev_iv.append((start, start + dur))
            k = kernels.setdefault(_kernel_name(name), [0, 0.0])
            k[0] += 1
            k[1] += dur * 1e-9
        else:
            if name == span_name:
                span = (start, start + dur)
            elif not name.startswith("cuda") and dur > 0:
                host.append((start, start + dur, name))
    if span is None or not dev_iv:
        return {}
    lo, hi = span
    dev_iv.sort()
    busy, gaps, cur = 0, [], None
    for a, b in dev_iv:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur is None:
            if a > lo:
                gaps.append((lo, a))
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
        if cur[1] < hi:
            gaps.append((cur[1], hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle: dict = {}
    for a, b in gaps[:200]:
        mid = (a + b) // 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        label = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                 else "no host op")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    top_ops = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9,
            "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in top_ops[:10]],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda x: x[1], reverse=True)[:10]}


# ---- statistics of a window -----------------------------------------------


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    i = int(pos)
    j = min(i + 1, len(xs) - 1)
    return xs[i] + (xs[j] - xs[i]) * (pos - i)


# ---- the result line ------------------------------------------------------


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list,
                breakdown: dict | None = None) -> dict:
    """The run's last line: the keys its readers expect, then each
    number compared beside its limit under ``checks``, which comes last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = [{"name": c["name"], "value": c["value"],
                       "limit": c["limit"]} for c in checks]
    return line
