"""The tuning table: run-time values of the kernels and layers, tuned on
the card and kept between processes.

The JAX package's ``ops/autotune.py`` tunes the Pallas kernels' block
edges, the fused-CE vocab chunk and the DP gradient-bucket budget. Here:

* a **persistent table** keyed on (kernel, shape, dtype, platform):
  ``lookup`` and the ``*_for`` resolvers never sweep and never write (the
  tested default on a miss); ``record`` writes an entry and persists the
  file; the ``ensure_*`` functions sweep a candidate grid on the card and
  record the winner;
* the tuned values, each with its candidates and its default:

  - ``decode_split``: the keys a split of K5/K6's split regime covers
    (``ops/decode_attention.py``; default :func:`split_keys`'s 256, or
    128 for f32 rows wider than 64). **K5 and K6 read ONE entry**, keyed
    on (heads, head dim, cache dtype, platform) and never on the batch,
    the capacity, a length or the pool. The JAX package keeps two keys
    (``decode_attend``, ``decode_paged``) keyed on the capacity; here the
    count a split covers is what makes a request's partials independent
    of its batch-mates, and the engine (K6) equal the one-shot (K5)
    bitwise, so both kernels and every shape of a model must take the
    same one. Its sweep times K5 and K6 at the caller's shapes and keeps
    the keys with the least summed time;
  - ``fused_ce``: the vocab chunk of ``ops/fused_ce.py`` (default 8192
    clipped to the local vocab);
  - ``dp_bucket``: the gradient-bucket budget of ``parallel/overlap.py``
    (default 4 MiB). It sweeps only with a caller's ``measure``, which
    times the caller's own step;
  - the flash kernels K1-K4 take no tuned value: their tile is compiled
    (``ops/flash_attention.TILE``). ``lookup`` / ``blocks_for`` give it
    and nothing sweeps it;
* the **online front door** :func:`ensure_tuned_online`: off by default
  (``DTG_ONLINE_TUNE``, or :func:`set_online_tune`, which wins over the
  environment); one attempt a key a process, even when its sweep fails;
  a per-process budget (``DTG_ONLINE_TUNE_BUDGET_S``, 120 s); never a
  sweep while the current CUDA stream captures a graph (it would break
  the capture). A candidate or a sweep that fails is counted in
  :func:`online_tune_stats`'s ``failed``, with its key and error.

Platform and hermeticity: the platform key is the operands' card, name
and compute capability (``cuda:NVIDIA-H100-80GB-HBM3:sm90``), so a table
tuned on one card misses on another. Operands on the CPU are
defaults-only: the file is neither read nor written there and sweeps are
refused, whether or not the machine has a card, so the CPU suite is
hermetic wherever it runs.

Ranks: under a process group of more than one rank, a value passed
through :func:`ensure_tuned_online` with ``group=`` is decided by the
group's first rank and broadcast before use; every rank runs the same
sweep (a caller's ``measure`` may run collectives) but only the first
writes the table. A bucket budget or a vocab-parallel CE chunk that
differed between ranks would give different bucket layouts or chunk
loops, and the collectives would hang or sum the wrong tensors.

The table lives at ``$DTG_AUTOTUNE_TABLE``, else
``~/.cache/dtg_autotune_torch/table_v1.json``; it is machine state and
never in the repo.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Callable

import torch

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "carry_step")
DECODE_SPLIT_KERNEL = "decode_split"
CE_KERNEL = "fused_ce"
BUCKET_KERNEL = "dp_bucket"

# keys a split may cover: those the kernels' entry point accepts (a
# multiple of 8 warps, at most one key a lane of the 8 warps: 256) from
# 64 up, filtered per head dim and cache dtype by the shared memory of a
# split CTA (ops/decode_attention.split_keys_fit)
SPLIT_KEYS_CANDIDATES = (64, 128, 256)
SPLIT_GRAPH_CALLS = 10  # calls a captured graph of the split sweep times

# the JAX package's fused-CE default and grid
DEFAULT_CE_CHUNK = 8192
CE_CHUNK_CANDIDATES = (1024, 2048, 4096, 8192, 16384, 32768)

# the JAX package's bucket default (PyTorch DDP's is 25 MB) and grid
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024
BUCKET_BYTES_CANDIDATES = tuple((1 << 20) * m for m in (1, 2, 4, 8, 16, 32))

_ERROR_CHARS = 200  # of a failure's message, kept in the stats

_lock = threading.Lock()
_mem: dict[str, dict] = {}  # the in-memory table; the file merges in lazily
_loaded_from: str | None = None
_device_platform: dict[int, str] = {}


def default_blocks() -> tuple[int, int]:
    """The flash kernels' compiled tile, (TILE, TILE)."""
    from distributed_tensorflow_guide_tpu_torch.ops.flash_attention import (
        TILE,
    )

    return (TILE, TILE)


# --------------------------------------------------------------------------
# keys, persistence, hermeticity
# --------------------------------------------------------------------------


def _platform(platform: str | None = None, device=None) -> str:
    """The table's platform key: ``platform`` where given (the tests' fake
    card), else the device's: "cpu", or "cuda:<name>:sm<major><minor>" of
    the card. ``device=None`` is the current card where there is one."""
    if platform is not None:
        return platform
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() \
            else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    plat = _device_platform.get(idx)
    if plat is None:
        name = torch.cuda.get_device_name(idx).replace(" ", "-")
        major, minor = torch.cuda.get_device_capability(idx)
        plat = _device_platform[idx] = f"cuda:{name}:sm{major}{minor}"
    return plat


def table_path() -> Path:
    """``$DTG_AUTOTUNE_TABLE``, else a file under the user's cache."""
    env = os.environ.get("DTG_AUTOTUNE_TABLE")
    if env:
        return Path(env)
    return Path(os.path.expanduser(
        "~/.cache/dtg_autotune_torch/table_v1.json"))


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    import numpy as np

    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


def _key(kernel: str, b: int, h: int, s: int, d: int, dtype: str,
         causal: bool, platform: str) -> str:
    """The JAX package's key layout."""
    mode = "causal" if causal else "full"
    return f"{kernel}|b{b}|h{h}|s{s}|d{d}|{dtype}|{mode}|{platform}"


def reset() -> None:
    """Drop the in-memory table and the online session state (attempts,
    time spent, failures, agreed values, the override); the next lookup
    on a card reloads the file."""
    global _loaded_from, _online_override, _online_spent_s
    with _lock:
        _mem.clear()
        _loaded_from = None
        _online_override = None
        _online_attempted.clear()
        _online_failures.clear()
        _agreed.clear()
        _online_spent_s = 0.0


def _maybe_load(platform: str) -> None:
    """Merge the persisted table into memory, never on the CPU."""
    global _loaded_from
    if platform == "cpu":
        return
    path = table_path()
    with _lock:
        if _loaded_from == str(path):
            return
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError):
            data = {}
        if isinstance(data, dict):
            for k, v in data.items():
                _mem.setdefault(k, v)  # in-memory entries win
        _loaded_from = str(path)


def _persist_locked() -> None:
    """Write the in-memory table to disk, through a temporary file and a
    rename (the caller holds ``_lock``)."""
    path = table_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(_mem, indent=1, sort_keys=True))
    os.replace(tmp, path)


def _refuse_cpu(plat: str, what: str) -> None:
    if plat == "cpu":
        raise RuntimeError(
            f"autotune {what} refused on the CPU platform: the CPU is a "
            "defaults-only path (no table reads or writes, no sweeps), so "
            "what it runs never depends on tuning state")


def _entry(key: str, field: str):
    ent = _mem.get(key)
    if not isinstance(ent, dict):
        return None
    try:
        return int(ent[field])
    except (KeyError, TypeError, ValueError):
        return None


def _write(keys: list[str], ent: dict) -> None:
    with _lock:
        for k in keys:
            _mem[k] = dict(ent)
        _persist_locked()


def _failed(kernel: str, key: dict, error: BaseException | str,
            candidate=None) -> dict:
    """Count one failure (a candidate, or a whole sweep) in the stats."""
    rec = {"kernel": kernel,
           "key": {k: _dtype_name(v) if not isinstance(v, (int, float, str))
                   else v for k, v in key.items()},
           "error": str(error)[:_ERROR_CHARS]}
    if candidate is not None:
        rec["candidate"] = candidate
    with _lock:
        _online_failures.append(rec)
    return rec


def _sweep(kernel: str, key: dict, cands, measure: Callable) -> tuple:
    """Time every candidate (each failure isolated and counted): the
    fastest, and the swept and failed records."""
    timed, failed = {}, []
    for c in cands:
        try:
            timed[c] = float(measure(c))
        except Exception as e:  # noqa: BLE001 - counted, the sweep goes on
            failed.append(_failed(kernel, key, e, candidate=c))
    best = min(timed, key=timed.get) if timed else None
    return best, timed, failed


# --------------------------------------------------------------------------
# the flash kernels: a compiled tile, nothing to tune
# --------------------------------------------------------------------------


def _check_flash(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (one of {KERNELS})")


def lookup(kernel: str, **key) -> tuple[int, int]:
    """The blocks a flash kernel runs: its compiled tile, whatever the
    key and the table (the CUDA kernels tile by ``TILE`` rows; a tile
    variant to sweep would be a kernel change)."""
    _check_flash(kernel)
    return default_blocks()


def blocks_for(kernel: str, **key) -> tuple[int, int]:
    """The flash kernels' compiled tile; never sweeps, never writes."""
    return lookup(kernel, **key)


def ensure_tuned(kernel: str, **key) -> tuple[int, int]:
    """The flash kernels' compiled tile: nothing to sweep."""
    return lookup(kernel, **key)


def record(kernel: str, **key) -> None:
    """Refused: a flash kernel's tile is compiled, not a table value."""
    _check_flash(kernel)
    raise ValueError(f"{kernel}: the tile is compiled "
                     f"({default_blocks()}), not a tuned value")


def kernel_flops(kernel: str, *, b: int, h: int, s: int, d: int,
                 causal: bool = True, **_) -> float:
    """Operations of one flash kernel call: the port's own model
    (``flash_attention.flash_kernel_flops``: 2 * hd a visible pair a
    product, at the head dim as it is). The JAX package's counts live
    Pallas blocks at its block edge over a head dim padded to 128 lanes,
    which the CUDA kernels do not pad."""
    from distributed_tensorflow_guide_tpu_torch.ops import flash_attention

    _check_flash(kernel)
    name = "flash_carry" if kernel == "carry_step" else kernel
    return flash_attention.flash_kernel_flops(name, b=b, h=h, s=s, d=d,
                                              causal=causal)


def kernel_hbm_bytes(kernel: str, *, b: int, h: int, s: int, d: int,
                     dtype, **kw) -> float:
    """Least device-memory traffic of one call: the port's own models
    (``flash_attention.flash_kernel_bytes``; for ``decode_split``,
    ``decode_attention.decode_kernel_hbm_bytes`` at ``dtype`` the cache
    dtype, with its ``chunk``, ``q_dtype`` and ``effective_len``)."""
    from distributed_tensorflow_guide_tpu_torch.ops import (
        decode_attention,
        flash_attention,
    )

    if kernel == DECODE_SPLIT_KERNEL:
        return decode_attention.decode_kernel_hbm_bytes(
            b=b, h=h, s=s, d=d, dtype=dtype, **kw)
    _check_flash(kernel)
    name = "flash_carry" if kernel == "carry_step" else kernel
    return flash_attention.flash_kernel_bytes(name, b=b, h=h, s=s, d=d,
                                              dtype=dtype)


# --------------------------------------------------------------------------
# K5/K6: keys a split (ops/decode_attention.py)
# --------------------------------------------------------------------------


def split_keys_candidates(d: int, dtype,
                          block_size: int | None = None) -> list[int]:
    """The sweep grid for one head dim and cache dtype: the candidates
    the kernels take (``decode_attention.split_keys_fit``), and, with
    ``block_size``, multiples of the pool's block size."""
    from distributed_tensorflow_guide_tpu_torch.ops import decode_attention

    return [k for k in SPLIT_KEYS_CANDIDATES
            if decode_attention.split_keys_fit(k, d, dtype)
            and (block_size is None or k % block_size == 0)]


def _split_key(h: int, d: int, dtype, plat: str) -> str:
    return _key(DECODE_SPLIT_KERNEL, 0, h, 0, d, _dtype_name(dtype), False,
                plat)


def split_keys_lookup(*, h: int, d: int, dtype, block_size=None,
                      platform: str | None = None,
                      device=None) -> int | None:
    """The tuned keys a split for (h, d, cache dtype, platform), or None.
    An entry the kernels would refuse (keys off the grid's rules, past a
    CTA's shared memory, or, with ``block_size``, not a multiple of it) is
    ignored: a stale table never reaches the kernel."""
    plat = _platform(platform, device)
    _maybe_load(plat)
    keys = _entry(_split_key(h, d, dtype, plat), "keys")
    if keys is None or keys not in split_keys_candidates(d, dtype,
                                                          block_size):
        return None
    return keys


def split_keys_for(*, h: int, d: int, dtype, block_size=None,
                   platform: str | None = None, device=None) -> int:
    """The keys a split K5 and K6 take: the tuned entry, else the fixed
    rule (``decode_attention.split_keys``). Never sweeps, never writes;
    on the CPU the table is never read."""
    from distributed_tensorflow_guide_tpu_torch.ops import decode_attention

    hit = split_keys_lookup(h=h, d=d, dtype=dtype, block_size=block_size,
                            platform=platform, device=device)
    return hit if hit is not None else decode_attention.split_keys(
        _torch_dtype(dtype), d)


def split_keys_record(*, h: int, d: int, dtype, keys: int,
                      detail: dict | None = None,
                      platform: str | None = None, device=None) -> None:
    """Write the ``decode_split`` entry and persist; refused on the CPU
    and for keys the kernels would refuse."""
    plat = _platform(platform, device)
    _refuse_cpu(plat, "split_keys_record")
    keys = int(keys)
    if keys not in split_keys_candidates(d, dtype):
        raise ValueError(f"keys {keys} invalid for head dim {d} and "
                         f"{_dtype_name(dtype)} rows (one of "
                         f"{split_keys_candidates(d, dtype)})")
    _maybe_load(plat)
    ent = {"keys": keys}
    if detail:
        ent["detail"] = detail
    _write([_split_key(h, d, dtype, plat)], ent)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, _dtype_name(dtype))


def ensure_split_keys_tuned(*, h: int, d: int, dtype, b: int, s: int,
                            block_size: int, n_blk: int | None = None,
                            q_dtype=None, iters: int = 20,
                            measure: Callable | None = None,
                            record_entry: bool = True,
                            platform: str | None = None,
                            device=None) -> int:
    """The tuned keys a split, from the table when present (no re-sweep),
    else swept and recorded: ``measure(keys) -> seconds`` for each
    candidate (the default times one K5 call, B=``b``, S=``s``, C=1, plus
    one K6 call at the same B over a pool of ``block_size`` blocks,
    ``n_blk`` a table (default S / block_size), every request at full
    length, each on the card: ``SPLIT_GRAPH_CALLS`` calls captured in a
    CUDA graph, as the engine's and the one-shot's decode steps launch
    them, median of ``iters`` replays after a warm-up) and the least sum
    wins. Refused on the CPU."""
    hit = split_keys_lookup(h=h, d=d, dtype=dtype, block_size=block_size,
                            platform=platform, device=device)
    if hit is not None:
        return hit
    plat = _platform(platform, device)
    _refuse_cpu(plat, "split-keys sweep")
    cands = split_keys_candidates(d, dtype, block_size)
    key = {"h": h, "d": d, "dtype": dtype}
    parts: dict[int, dict] = {}
    if measure is None:
        from distributed_tensorflow_guide_tpu_torch.ops import (
            decode_attention,
        )

        runners = decode_attention.make_split_runners(
            b=b, h=h, s=s, d=d, dtype=_torch_dtype(dtype),
            q_dtype=q_dtype, block_size=block_size, n_blk=n_blk,
            device=device if device is not None else "cuda")

        def measure(keys):  # noqa: F811 - documented injection point
            k5, k6 = (measure_runner(lambda r=r: r(keys), iters=iters,
                                     device=runners.device,
                                     graph_calls=SPLIT_GRAPH_CALLS)
                      for r in (runners.k5, runners.k6))
            parts[keys] = {"k5_ms": 1e3 * k5, "k6_ms": 1e3 * k6}
            return k5 + k6

    best, timed, failed = _sweep(DECODE_SPLIT_KERNEL, key, cands, measure)
    if best is None:
        return split_keys_for(h=h, d=d, dtype=dtype, block_size=block_size,
                              platform=plat)
    if record_entry:
        detail = {"iters": iters, "b": b, "s": s, "block_size": block_size,
                  "swept": [{"keys": k, "secs_per_call": t,
                             **parts.get(k, {})}
                            for k, t in sorted(timed.items())]}
        if failed:
            detail["failed"] = failed
        split_keys_record(h=h, d=d, dtype=dtype, keys=best, detail=detail,
                          platform=plat)
    return best


# --------------------------------------------------------------------------
# the fused-CE chunk (ops/fused_ce.py)
# --------------------------------------------------------------------------


def ce_chunk_candidates(v: int) -> list[int]:
    """The sweep grid for one vocab width: chunks strictly narrower than
    the vocab (at chunk >= V the loop is the one-chunk pass the default
    already covers)."""
    return [c for c in CE_CHUNK_CANDIDATES if c < v]


def ce_chunk_lookup(*, n: int, d: int, v: int, dtype,
                    platform: str | None = None,
                    device=None) -> int | None:
    """The tuned chunk, or None: the exact-N entry, then the N-generic
    one. An entry wider than the vocab is clipped to it; one below 1 is
    ignored."""
    plat = _platform(platform, device)
    _maybe_load(plat)
    dt = _dtype_name(dtype)
    for key in (_key(CE_KERNEL, n, 0, v, d, dt, False, plat),
                _key(CE_KERNEL, 0, 0, v, d, dt, False, plat)):
        chunk = _entry(key, "chunk")
        if chunk is not None and chunk > 0:
            return min(chunk, v)
    return None


def ce_chunk_for(*, n: int, d: int, v: int, dtype,
                 platform: str | None = None, device=None) -> int:
    """The chunk a fused-CE call takes: the tuned entry, else
    ``DEFAULT_CE_CHUNK`` clipped to the vocab. Never sweeps, never
    writes; on the CPU the table is never read."""
    hit = ce_chunk_lookup(n=n, d=d, v=v, dtype=dtype, platform=platform,
                          device=device)
    return hit if hit is not None else min(DEFAULT_CE_CHUNK, v)


def ce_record(*, n: int, d: int, v: int, dtype, chunk: int,
              detail: dict | None = None, platform: str | None = None,
              device=None, generalize: bool = True) -> None:
    """Write the exact-N entry (and the N-generic one) and persist;
    refused on the CPU."""
    plat = _platform(platform, device)
    _refuse_cpu(plat, "ce_record")
    chunk = int(chunk)
    if chunk < 1 or chunk > v:
        raise ValueError(f"chunk {chunk} invalid for vocab {v}")
    _maybe_load(plat)
    dt = _dtype_name(dtype)
    keys = [_key(CE_KERNEL, n, 0, v, d, dt, False, plat)]
    if generalize:
        keys.append(_key(CE_KERNEL, 0, 0, v, d, dt, False, plat))
    ent = {"chunk": chunk}
    if detail:
        ent["detail"] = detail
    _write(keys, ent)


def ce_measure(*, n: int, d: int, v: int, dtype, device, iters: int = 10,
               seed: int = 0) -> Callable[[int], float]:
    """``measure(chunk) -> seconds`` of one forward and backward of the
    fused NLL (``fused_ce._FusedNLL``) on random (N, d) activations in
    ``dtype`` against a (d, V) f32 head read through its transpose, as
    the LM's ``lm_head.weight.t()``."""
    from distributed_tensorflow_guide_tpu_torch.ops import fused_ce

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode(False):
        x = torch.randn(n, d, generator=gen, device=dev).to(
            _torch_dtype(dtype)).requires_grad_()
        w = (torch.randn(v, d, generator=gen, device=dev) * 0.02
             ).requires_grad_()
        targets = torch.randint(0, v, (n,), generator=gen, device=dev)

    def measure(chunk):
        def step():
            with torch.inference_mode(False), torch.enable_grad():
                loss = fused_ce._FusedNLL.apply(x, w.t(), targets, chunk,
                                                None, True)
                return torch.autograd.grad(loss, (x, w))

        return measure_runner(step, iters=iters, device=dev)

    return measure


def ensure_ce_tuned(*, n: int, d: int, v: int, dtype, iters: int = 10,
                    measure: Callable | None = None,
                    record_entry: bool = True,
                    platform: str | None = None, device=None) -> int:
    """The tuned chunk, from the table when present (no re-sweep), else
    swept over :func:`ce_chunk_candidates` and recorded.
    ``measure(chunk) -> seconds`` is injectable; the default is
    :func:`ce_measure` on the card. Refused on the CPU."""
    hit = ce_chunk_lookup(n=n, d=d, v=v, dtype=dtype, platform=platform,
                          device=device)
    if hit is not None:
        return hit
    plat = _platform(platform, device)
    _refuse_cpu(plat, "CE sweep")
    cands = ce_chunk_candidates(v)
    if not cands:
        return ce_chunk_for(n=n, d=d, v=v, dtype=dtype, platform=plat)
    if measure is None:
        measure = ce_measure(n=n, d=d, v=v, dtype=dtype, iters=iters,
                             device=device if device is not None
                             else "cuda")
    key = {"n": n, "d": d, "v": v, "dtype": dtype}
    best, timed, failed = _sweep(CE_KERNEL, key, cands, measure)
    if best is None:
        return ce_chunk_for(n=n, d=d, v=v, dtype=dtype, platform=plat)
    if record_entry:
        detail = {"iters": iters,
                  "swept": [{"chunk": c, "secs_per_call": t}
                            for c, t in sorted(timed.items())]}
        if failed:
            detail["failed"] = failed
        ce_record(n=n, d=d, v=v, dtype=dtype, chunk=best, detail=detail,
                  platform=plat)
    return best


# --------------------------------------------------------------------------
# the DP gradient-bucket budget (parallel/overlap.py)
# --------------------------------------------------------------------------


def bucket_candidates(param_bytes: int) -> list[int]:
    """The sweep grid for one gradient-tree size: budgets strictly below
    it (at or past it the buckets are one monolithic all-reduce)."""
    return [c for c in BUCKET_BYTES_CANDIDATES if c < param_bytes]


def _param_mib(param_bytes: int) -> int:
    """The size key in MiB: nearby models share an entry."""
    return max(1, round(param_bytes / (1 << 20)))


def bucket_lookup(*, param_bytes: int, world: int, dtype,
                  platform: str | None = None,
                  device=None) -> int | None:
    """The tuned budget, or None: the exact-world entry, then the
    world-generic one. An entry below 1 byte is ignored."""
    plat = _platform(platform, device)
    _maybe_load(plat)
    dt = _dtype_name(dtype)
    mib = _param_mib(param_bytes)
    for key in (_key(BUCKET_KERNEL, world, 0, mib, 0, dt, False, plat),
                _key(BUCKET_KERNEL, 0, 0, mib, 0, dt, False, plat)):
        bb = _entry(key, "bucket_bytes")
        if bb is not None and bb > 0:
            return bb
    return None


def bucket_bytes_for(*, param_bytes: int, world: int, dtype,
                     platform: str | None = None, device=None) -> int:
    """The budget a bucketed backward takes: the tuned entry, else
    ``DEFAULT_BUCKET_BYTES``. Never sweeps, never writes; on the CPU the
    table is never read."""
    hit = bucket_lookup(param_bytes=param_bytes, world=world, dtype=dtype,
                        platform=platform, device=device)
    return hit if hit is not None else DEFAULT_BUCKET_BYTES


def bucket_record(*, param_bytes: int, world: int, dtype,
                  bucket_bytes: int, detail: dict | None = None,
                  platform: str | None = None, device=None,
                  generalize: bool = True) -> None:
    """Write the exact-world entry (and the world-generic one) and
    persist; refused on the CPU."""
    plat = _platform(platform, device)
    _refuse_cpu(plat, "bucket_record")
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes {bucket_bytes} invalid (need >= 1)")
    _maybe_load(plat)
    dt = _dtype_name(dtype)
    mib = _param_mib(param_bytes)
    keys = [_key(BUCKET_KERNEL, world, 0, mib, 0, dt, False, plat)]
    if generalize:
        keys.append(_key(BUCKET_KERNEL, 0, 0, mib, 0, dt, False, plat))
    ent = {"bucket_bytes": bucket_bytes}
    if detail:
        ent["detail"] = detail
    _write(keys, ent)


def ensure_bucket_tuned(*, param_bytes: int, world: int, dtype,
                        measure: Callable[[int], float],
                        record_entry: bool = True,
                        platform: str | None = None, device=None) -> int:
    """The tuned budget, from the table when present (no re-sweep), else
    swept over :func:`bucket_candidates` with the caller's
    ``measure(bucket_bytes) -> seconds a step`` (required: the right
    budget is a property of the caller's model and mesh) and recorded.
    Refused on the CPU."""
    hit = bucket_lookup(param_bytes=param_bytes, world=world, dtype=dtype,
                        platform=platform, device=device)
    if hit is not None:
        return hit
    plat = _platform(platform, device)
    _refuse_cpu(plat, "bucket sweep")
    cands = bucket_candidates(param_bytes)
    key = {"param_bytes": param_bytes, "world": world, "dtype": dtype}
    best, timed, failed = _sweep(BUCKET_KERNEL, key, cands, measure)
    if best is None:
        return bucket_bytes_for(param_bytes=param_bytes, world=world,
                                dtype=dtype, platform=plat)
    if record_entry:
        detail = {"param_bytes": int(param_bytes), "world": int(world),
                  "swept": [{"bucket_bytes": bb, "secs_per_step": t}
                            for bb, t in sorted(timed.items())]}
        if failed:
            detail["failed"] = failed
        bucket_record(param_bytes=param_bytes, world=world, dtype=dtype,
                      bucket_bytes=best, detail=detail, platform=plat)
    return best


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def measure_runner(fn: Callable[[], object], *, iters: int = 20,
                   warmup: int = 2, device=None,
                   graph_calls: int = 0) -> float:
    """Seconds a call of ``fn``: ``warmup`` calls, then the median of
    ``iters`` calls, each between two CUDA events on the current stream
    of the card (``device``, default the current card where there is
    one); on the CPU, the host clock around each call.

    ``graph_calls`` > 0 (the card only): ``graph_calls`` calls captured in
    one CUDA graph, and the median of ``iters`` replays, each between two
    events, over ``graph_calls``: the card's own time, without the
    host's launch cost, which would set the time of a kernel that takes
    less than the launch (as in a captured decode step, where the graph
    launches it)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    for _ in range(max(1, warmup)):
        fn()
    if device.type == "cuda" and graph_calls > 0:
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(graph_calls):
                fn()
        graph.replay()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            start.record()
            graph.replay()
            end.record()
        events[-1][1].synchronize()
        times = sorted(start.elapsed_time(end) / 1e3 / graph_calls
                       for start, end in events)
        del graph
        return times[len(times) // 2]
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    else:
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        for start, end in events:
            start.record()
            fn()
            end.record()
        events[-1][1].synchronize()
        times = [start.elapsed_time(end) / 1e3 for start, end in events]
    times.sort()
    return times[len(times) // 2]


# --------------------------------------------------------------------------
# online in-situ tuning
# --------------------------------------------------------------------------
#
# A call site that resolves a key with no table entry runs the sweep in
# situ (the first call pays it once), records the winner, and every later
# resolution, in this process or the next, is a lookup hit. Bounds:
# default off; defaults-only on the CPU; never during a graph capture; at
# most one attempt a key a process, failed or not; a per-process budget.

_ONLINE_ENV = "DTG_ONLINE_TUNE"
_ONLINE_BUDGET_ENV = "DTG_ONLINE_TUNE_BUDGET_S"
DEFAULT_ONLINE_BUDGET_S = 120.0

_online_override: bool | None = None
_online_attempted: set = set()
_online_failures: list[dict] = []
_online_spent_s: float = 0.0
_agreed: dict = {}  # (attempt key, group) -> the value a group agreed on


def set_online_tune(enabled: bool | None) -> bool | None:
    """Set (or with None clear) the process-wide override, which wins
    over ``DTG_ONLINE_TUNE``; returns the previous override. Process
    state, as the table is: a component that opts in tunes for every
    consumer of the shared table."""
    global _online_override
    with _lock:
        prev = _online_override
        _online_override = None if enabled is None else bool(enabled)
        _agreed.clear()  # a group decides again under the new setting
    return prev


def online_tune_enabled() -> bool:
    """The override where one is set, else ``DTG_ONLINE_TUNE`` (truthy:
    anything but empty, 0, false, no, off)."""
    if _online_override is not None:
        return _online_override
    raw = os.environ.get(_ONLINE_ENV, "").strip().lower()
    return raw not in ("", "0", "false", "no", "off")


def online_tune_budget_s() -> float:
    """The per-process budget of in-situ sweeps
    (``DTG_ONLINE_TUNE_BUDGET_S``, default 120 s)."""
    raw = os.environ.get(_ONLINE_BUDGET_ENV, "")
    try:
        return float(raw) if raw else DEFAULT_ONLINE_BUDGET_S
    except ValueError:
        return DEFAULT_ONLINE_BUDGET_S


def online_tune_stats() -> dict:
    """What the online tuner has done in this process: keys attempted,
    seconds spent, the budget, and ``failed``, the failed candidates and
    sweeps (``failures``: each one's kernel, key, candidate and the first
    200 characters of its error)."""
    with _lock:
        return {
            "enabled": online_tune_enabled(),
            "attempted": len(_online_attempted),
            "spent_s": _online_spent_s,
            "budget_s": online_tune_budget_s(),
            "failed": len(_online_failures),
            "failures": [dict(f) for f in _online_failures],
        }


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _lookup_hit(kernel: str, plat: str, key: dict):
    if kernel == CE_KERNEL:
        return ce_chunk_lookup(platform=plat, **key)
    if kernel == BUCKET_KERNEL:
        return bucket_lookup(platform=plat, **key)
    if kernel == DECODE_SPLIT_KERNEL:
        return split_keys_lookup(platform=plat, **key)
    return lookup(kernel, **key)


def _default_of(kernel: str, plat: str, key: dict, fallback):
    if fallback is not None:
        return fallback()
    if kernel == CE_KERNEL:
        return ce_chunk_for(platform=plat, **key)
    if kernel == BUCKET_KERNEL:
        return bucket_bytes_for(platform=plat, **key)
    if kernel == DECODE_SPLIT_KERNEL:
        return split_keys_for(platform=plat, **key)
    return blocks_for(kernel, **key)


def _attempt_key(kernel: str, plat: str, key: dict) -> tuple:
    return (kernel, plat, tuple(sorted(
        (k, _dtype_name(v) if not isinstance(v, (int, float, str)) else v)
        for k, v in key.items())))


def _may_sweep(kernel: str, plat: str, key: dict, measure) -> bool:
    """Whether this call may sweep, and if so the attempt is taken: on,
    a card, not capturing, a measure for a bucket key, no table entry,
    not attempted, budget left."""
    if kernel in KERNELS or not online_tune_enabled() or plat == "cpu":
        return False
    if kernel == BUCKET_KERNEL and measure is None:
        return False
    if _capturing() or _lookup_hit(kernel, plat, key) is not None:
        return False
    akey = _attempt_key(kernel, plat, key)
    with _lock:
        if (akey in _online_attempted
                or _online_spent_s >= online_tune_budget_s()):
            return False
        _online_attempted.add(akey)  # one attempt, even when it fails
    return True


def _run_sweep(kernel: str, plat: str, key: dict, measure, iters: int,
               shape: dict | None, device, record_entry: bool):
    if kernel == CE_KERNEL:
        return ensure_ce_tuned(iters=iters, measure=measure, platform=plat,
                               device=device, record_entry=record_entry,
                               **key)
    if kernel == BUCKET_KERNEL:
        return ensure_bucket_tuned(measure=measure, platform=plat,
                                   device=device,
                                   record_entry=record_entry, **key)
    if shape is None:
        raise ValueError("a decode_split sweep needs the caller's shape "
                         "(b, s, block_size[, n_blk, q_dtype])")
    return ensure_split_keys_tuned(iters=iters, measure=measure,
                                   platform=plat, device=device,
                                   record_entry=record_entry,
                                   **key, **shape)


def _timed_sweep(kernel, plat, key, measure, iters, shape, device,
                 record_entry):
    """The sweep, its time charged to the budget; a sweep that raises is
    counted and gives None."""
    global _online_spent_s
    t0 = time.perf_counter()
    try:
        return _run_sweep(kernel, plat, key, measure, iters, shape, device,
                          record_entry)
    except Exception as e:  # noqa: BLE001 - counted; serving goes on
        _failed(kernel, key, e)
        return None
    finally:
        with _lock:
            _online_spent_s += time.perf_counter() - t0


def _group_size(group) -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _broadcast_int(value: int, group, src: int) -> int:
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=src, group=group)
    return int(t.item())


def ensure_tuned_online(kernel: str, *, measure: Callable | None = None,
                        iters: int = 20, fallback: Callable | None = None,
                        platform: str | None = None, device=None,
                        group=None, shape: dict | None = None, **key):
    """The one online resolution path of every tuned value.

    ``kernel`` picks the family and ``key`` its key fields:
    :data:`DECODE_SPLIT_KERNEL` (``h, d, dtype``[, ``block_size``]; its
    sweep times the caller's ``shape``: ``b, s, block_size``[, ``n_blk``,
    ``q_dtype``]) gives the keys a split; :data:`CE_KERNEL` (``n, d, v,
    dtype``) the chunk; :data:`BUCKET_KERNEL` (``param_bytes, world,
    dtype``) the budget, and sweeps only with a ``measure``; a flash
    kernel its compiled tile. ``fallback`` is the zero-argument default
    the caller would take (the family's ``*_for`` when None).

    No sweep, and the fallback exactly, when: online tuning is off, the
    platform is the CPU, the current stream is capturing a graph, the
    table has the key, the key was attempted before in this process, the
    budget is spent, or the sweep raised (counted in ``failed``).

    ``group``: a process group (``torch.distributed.group.WORLD`` for
    the world) of more than one rank agrees on the value:
    its first rank decides whether to sweep, every rank then runs the
    same sweep (``record`` on the first rank only) or none, and the first
    rank's value is broadcast. Every rank of the group must make the
    call, in the same order; a value agreed once is kept (until
    :func:`reset` or :func:`set_online_tune`)."""
    plat = _platform(platform, device)
    # on the CPU every rank takes the default: agreed without a message
    if group is None or plat == "cpu" or _group_size(group) <= 1:
        if not _may_sweep(kernel, plat, key, measure):
            return _default_of(kernel, plat, key, fallback)
        got = _timed_sweep(kernel, plat, key, measure, iters, shape, device,
                           record_entry=True)
        return got if got is not None else _default_of(kernel, plat, key,
                                                       fallback)
    return _agree(kernel, plat, key, measure, iters, fallback, shape,
                  device, group)


def _agree(kernel, plat, key, measure, iters, fallback, shape, device,
           group):
    """:func:`ensure_tuned_online` over a group of several ranks."""
    import torch.distributed as dist

    akey = (_attempt_key(kernel, plat, key), id(group))
    with _lock:
        if akey in _agreed:
            return _agreed[akey]
    if _capturing():  # no collective inside a capture: the local value
        return _default_of(kernel, plat, key, fallback)
    src = dist.get_global_rank(group, 0) if group is not None else 0
    first = dist.get_rank() == src
    may = _broadcast_int(
        first and _may_sweep(kernel, plat, key, measure), group, src)
    value = None
    if may:
        if not first:
            with _lock:
                _online_attempted.add(_attempt_key(kernel, plat, key))
        value = _timed_sweep(kernel, plat, key, measure, iters, shape,
                             device, record_entry=first)
    if first and value is None:
        value = _default_of(kernel, plat, key, fallback)
    value = _broadcast_int(value if first else 0, group, src)
    with _lock:
        _agreed[akey] = value
    return value
