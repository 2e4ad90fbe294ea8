"""Checkpoint/resume: the CheckpointSaverHook, over ``torch.save``.

The JAX package saves through Orbax; here a checkpoint is one directory
per step, ``<directory>/<step>/``, holding ``state.pt`` (``torch.save`` of
the state as a tree of host tensors, read back with
``torch.load(weights_only=True)``) and ``meta.json`` (world size,
sharding). What a state may be: a :class:`~.state.TrainState` (the
module's parameters and buffers, ``optimizer.state_dict()`` and
``step``), a module, an optimizer, a ``torch.Generator``, a dataclass of
those (``parallel/multislice.TwoTierState``), and dicts, lists and tuples
of those and of tensors, numpy arrays and Python scalars.

The resilience contract is the reference's:

* **Async saves** (``save(..., async_=True)``) copy the state to host
  before they return: CUDA tensors into pinned host buffers with
  non-blocking copies on a side stream, then a wait on an event recorded
  after them; CPU tensors are cloned. ``TrainState.apply_gradients``
  updates the parameters and Adam moments in place, so the next step may
  overwrite them as soon as ``save`` returns. A background thread then
  serialises the host copy into ``<step>.ckpt-tmp/``. The *commit
  barrier* is the next ``save``/``restore``/``wait``/``latest_step``/
  ``close`` call: it joins the writer (re-raising its error there),
  renames the directory to ``<step>/`` and only then writes the manifest,
  so an async-saved step never looks durable before it is.
* **Integrity manifest**: every committed save gets a
  ``manifest_<step>.json`` (per-file size and CRC32), written atomically
  after the payload; the restore ladder trusts it. The writer sums the
  CRC of the bytes as it writes them, so a multi-gigabyte state is not
  read back to make its manifest.
* **Restore ladder**: :meth:`Checkpointer.restore_latest_valid` walks the
  steps newest to oldest and skips any that fail verification or restore.
* **Startup hygiene**: ``__init__`` removes ``*.ckpt-tmp`` directories and
  half-written manifests that a kill mid-save left behind.
* **Layout pin**: a ``layout_<step>.json`` sidecar (``default_layout`` or
  ``layout=``, e.g. ``PipelinedLM.layout_metadata()``) is compared at
  restore, and a mismatch raises :class:`LayoutMismatchError`.

**Restore writes in place.** A state object (``TrainState``, module,
optimizer, generator) is restored into its existing tensors with
``copy_``: a captured step (``core/graphs.MultiStep``, ``CapturedStep``)
replays fixed addresses, and ``optimizer.load_state_dict`` would make new
tensors the graph never sees. The optimizer keeps its ``capturable``
step tensors where they are. A saved optimizer with no state yet (a
fresh start) zeroes the live Adam / SGD state in place, which is what
those optimizers create at their first step; a live optimizer with no
state yet takes ``load_state_dict`` (no captured step can hold tensors
that do not exist). The whole saved tree is checked against the live
state (kinds, keys, shapes, dtypes, the optimizer's layout) before the
first tensor is written; a checkpoint that does not fit raises
:class:`StateMismatchError` and leaves the state as it was. The
tensors of a plain tree are returned new, on the device (and with the
dtype) of the matching tensor of ``state_like``: a checkpoint is never
restored to another device than the state asks for.

**Several ranks.** Replicated state (``sharded=False``): rank 0 writes,
and the others wait for it at a barrier. FSDP shards (``sharded=True``):
every rank writes ``state_rank<r>.pt`` and rank 0 writes the manifest
listing them all after a barrier. A restore needs the world size the
checkpoint was written with; another one raises
:class:`WorldSizeMismatchError` rather than resharding.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.train.hooks import BaseHook

log = logging.getLogger("dtg.train")

# "caller didn't say" sentinel for layout=: None stays expressible as an
# explicit "no layout pin, even if this Checkpointer has a default"
_UNSET: Any = object()

_TMP_SUFFIX = ".ckpt-tmp"
_MANIFEST_TMP_SUFFIX = ".tmp"
_META = "meta.json"
_KIND = "__kind__"


class LayoutMismatchError(ValueError):
    """Restoring model's layout identity differs from the saved one."""


class WorldSizeMismatchError(ValueError):
    """The checkpoint was written by another number of ranks."""


class StateMismatchError(ValueError):
    """The checkpoint does not fit the state it is restored into: another
    tree, key set, shape, dtype or optimizer layout. A configuration
    error, not corruption: the ladder re-raises it, and nothing of the
    state has been written when it is raised."""


class _CrcWriter:
    """A write-only file that keeps the size and CRC32 of what passed
    through it (``torch.save`` writes its zip stream through ``write``)."""

    def __init__(self, fh):
        self.fh, self.size, self.crc = fh, 0, 0

    def write(self, data) -> int:
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(memoryview(data).cast("B"))
        return self.fh.write(data)

    def flush(self) -> None:
        self.fh.flush()


def _crc32(path: Path) -> int:
    crc = 0
    with path.open("rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_writer() -> bool:
    """Manifests are chief-written: one writer per shared directory."""
    return _rank_world()[0] == 0


def _barrier() -> None:
    import torch.distributed as dist

    if _rank_world()[1] > 1:
        dist.barrier()


# ---- state <-> tree of tensors ---------------------------------------------


def _pack(obj: Any) -> Any:
    """The saveable tree of ``obj``: references to its tensors, no copies
    (numpy arrays excepted: their bytes are copied here)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {_KIND: "dataclass", "type": type(obj).__name__,
                "fields": {f.name: _pack(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, torch.nn.Module):
        return {_KIND: "module", "state": dict(obj.state_dict())}
    if isinstance(obj, torch.optim.Optimizer):
        return {_KIND: "optimizer", "state": obj.state_dict()}
    if isinstance(obj, torch.Generator):
        return {_KIND: "generator", "state": obj.get_state()}
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        return {_KIND: "numpy", "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "data": torch.from_numpy(
                    np.frombuffer(arr.tobytes(), np.uint8).copy())}
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


class _HostCopier:
    """Copies a packed tree to host memory before a save returns. CUDA
    tensors go into pinned buffers, reused from one save to the next when
    the tree's shapes repeat (the barrier before each save has released
    the previous ones), by non-blocking copies on one side stream, then a
    wait on an event recorded after the last copy."""

    def __init__(self):
        self._pinned: list[torch.Tensor] = []

    def __call__(self, tree: Any) -> Any:
        pending: list[tuple[torch.Tensor, torch.Tensor]] = []
        used = 0

        def copy(t: torch.Tensor) -> torch.Tensor:
            nonlocal used
            if t.device.type != "cuda":
                return t.clone()
            buf = (self._pinned[used] if used < len(self._pinned) else None)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                if used < len(self._pinned):
                    self._pinned[used] = buf
                else:
                    self._pinned.append(buf)
            used += 1
            pending.append((buf, t))
            return buf

        out = _map_tensors(copy, tree)
        del self._pinned[used:]
        if pending:
            dev = pending[0][1].device
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for buf, t in pending:
                    buf.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            done.synchronize()
        return out


def _plain(saved: Any) -> Any:
    """A loaded tree as plain data: numpy arrays back, the state objects'
    packed forms as their dicts."""
    if isinstance(saved, dict):
        kind = saved.get(_KIND)
        if kind == "numpy":
            raw = saved["data"].numpy().tobytes()
            return np.frombuffer(raw, np.dtype(saved["dtype"])).reshape(
                saved["shape"]).copy()
        if kind == "dataclass":
            return _plain(saved["fields"])
        if kind is not None:
            return {k: _plain(v) for k, v in saved.items() if k != _KIND}
        return {k: _plain(v) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        return type(saved)(_plain(v) for v in saved)
    return saved


def _expect(saved: Any, kind: str, path: str) -> dict:
    got = saved.get(_KIND) if isinstance(saved, dict) else None
    if got != kind:
        raise StateMismatchError(
            f"{path}: checkpoint holds a {got or type(saved).__name__} "
            f"where the state has a {kind}")
    return saved


def _check_tensor(live: torch.Tensor, saved: Any, path: str, *,
                  dtype: bool = True) -> None:
    if not isinstance(saved, torch.Tensor):
        raise StateMismatchError(f"{path}: checkpoint holds no tensor where "
                                 "the state has one")
    if live.shape != saved.shape or (dtype and live.dtype != saved.dtype):
        raise StateMismatchError(
            f"{path}: checkpoint has {tuple(saved.shape)} {saved.dtype}, "
            f"the state {tuple(live.shape)} {live.dtype}")


def _check_module(module: torch.nn.Module, saved: dict, path: str) -> None:
    live = module.state_dict(keep_vars=True)
    if set(live) != set(saved):
        raise StateMismatchError(
            f"{path}: checkpoint and module differ in their keys: missing "
            f"{sorted(set(live) - set(saved))[:5]}, unexpected "
            f"{sorted(set(saved) - set(live))[:5]}")
    for name, t in live.items():
        _check_tensor(t, saved[name], f"{path}.{name}")


_ZERO_STATE_OPTIMIZERS = (torch.optim.Adam, torch.optim.AdamW,
                          torch.optim.SGD)


def _same_layout(live: dict, saved: dict) -> bool:
    if live["state"].keys() != saved["state"].keys():
        return False
    return all(live["state"][i].keys() == saved["state"][i].keys()
               for i in live["state"])


def _optimizer_plan(opt: torch.optim.Optimizer, saved: dict,
                    path: str) -> str:
    """How ``saved`` goes into ``opt``, checked whole before anything is
    written: ``"copy"`` (the same state layout, copied in place),
    ``"zero"`` (a checkpoint of an optimizer that has not stepped, into
    a live Adam / SGD one that has: its state zeroed in place, which is
    what those optimizers create at their first step; SGD's momentum
    buffer starts as that step's gradient, which a zeroed buffer gives
    too, 0 * momentum + g) or ``"load"`` (a live optimizer with no state
    yet: ``load_state_dict`` makes its tensors, and no captured step can
    hold tensors that did not exist). Anything else raises."""
    live = opt.state_dict()
    sizes = [len(g["params"]) for g in live["param_groups"]]
    saved_groups = saved.get("param_groups")
    if (not isinstance(saved_groups, list) or not isinstance(
            saved.get("state"), dict)
            or [len(g.get("params", ())) for g in saved_groups] != sizes):
        raise StateMismatchError(
            f"{path}: the checkpoint's parameter groups do not match the "
            f"optimizer's ({sizes} parameters a group)")
    for i, (group, sg) in enumerate(zip(opt.param_groups, saved_groups)):
        for k, v in group.items():
            if k != "params" and torch.is_tensor(v):
                _check_tensor(v, sg.get(k), f"{path} group {i}.{k}",
                              dtype=False)
    if _same_layout(live, saved):
        for i, st in live["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    _check_tensor(v, saved["state"][i][k],
                                  f"{path} state {i}.{k}")
        return "copy"
    if not saved["state"] and isinstance(opt, _ZERO_STATE_OPTIMIZERS):
        return "zero"
    if not live["state"]:
        return "load"
    raise StateMismatchError(
        f"{path}: the optimizer's state ({len(live['state'])} parameters, "
        f"keys {sorted(next(iter(live['state'].values())))}) does not "
        f"match the checkpoint's ({len(saved['state'])} parameters)")


def _set_state_value(opt: torch.optim.Optimizer, index: int, key: str,
                     value: Any) -> None:
    """Set a non-tensor entry of the state of the ``index``-th parameter
    (``state_dict``'s numbering across the param groups)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    opt.state[params[index]][key] = value


def _load_optimizer(opt: torch.optim.Optimizer, saved: dict,
                    plan: str) -> None:
    if plan == "load":
        opt.load_state_dict(saved)
        return
    if plan == "zero":
        for st in opt.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    v.zero_()
    else:
        for i, st in opt.state_dict()["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    v.copy_(saved["state"][i][k])
                else:
                    _set_state_value(opt, i, k, saved["state"][i][k])
    for group, sg in zip(opt.param_groups, saved["param_groups"]):
        for k, v in sg.items():
            if k == "params":
                continue
            if torch.is_tensor(group.get(k)):
                group[k].copy_(v)
            else:
                group[k] = v


def _check_into(target: Any, saved: Any, path: str) -> None:
    """Raise :class:`StateMismatchError` unless ``saved`` fits ``target``
    leaf for leaf: the pass before :func:`_write_into` writes anything."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        saved = _expect(saved, "dataclass", path)
        names = {f.name for f in dataclasses.fields(target)}
        if (saved["type"] != type(target).__name__
                or set(saved["fields"]) != names):
            raise StateMismatchError(
                f"{path}: checkpoint holds a {saved['type']} with fields "
                f"{sorted(saved['fields'])} where the state has a "
                f"{type(target).__name__} with {sorted(names)}")
        for name, value in saved["fields"].items():
            _check_into(getattr(target, name), value, f"{path}.{name}")
    elif isinstance(target, torch.nn.Module):
        _check_module(target, _expect(saved, "module", path)["state"], path)
    elif isinstance(target, torch.optim.Optimizer):
        _optimizer_plan(target, _expect(saved, "optimizer", path)["state"],
                        path)
    elif isinstance(target, torch.Generator):
        _check_tensor(target.get_state(),
                      _expect(saved, "generator", path)["state"], path)
    elif isinstance(target, (np.ndarray, np.generic)):
        got = _expect(saved, "numpy", path)["shape"]
        if list(np.shape(target)) != list(got):
            raise StateMismatchError(f"{path}: checkpoint has shape {got}, "
                                     f"the state {list(np.shape(target))}")
    elif isinstance(target, torch.Tensor):
        _check_tensor(target, saved, path, dtype=False)
    elif isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            got = sorted(saved) if isinstance(saved, dict) else saved
            raise StateMismatchError(
                f"{path}: checkpoint tree and state differ in their keys: "
                f"{sorted(target)} against {got}")
        for k, v in target.items():
            _check_into(v, saved[k], f"{path}.{k}")
    elif isinstance(target, (list, tuple)):
        if (not isinstance(saved, (list, tuple))
                or len(saved) != len(target)):
            raise StateMismatchError(
                f"{path}: checkpoint tree and state differ in length")
        for i, (t, s) in enumerate(zip(target, saved)):
            _check_into(t, s, f"{path}[{i}]")


@torch.no_grad()
def _write_into(target: Any, saved: Any) -> Any:
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        for name, value in saved["fields"].items():
            setattr(target, name, _write_into(getattr(target, name), value))
        return target
    if isinstance(target, torch.nn.Module):
        live = target.state_dict(keep_vars=True)
        for name, t in live.items():
            t.copy_(saved["state"][name])
        return target
    if isinstance(target, torch.optim.Optimizer):
        _load_optimizer(target, saved["state"],
                        _optimizer_plan(target, saved["state"], ""))
        return target
    if isinstance(target, torch.Generator):
        target.set_state(saved["state"])
        return target
    if isinstance(target, (np.ndarray, np.generic)):
        return _plain(saved)
    if isinstance(target, torch.Tensor):
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        return {k: _write_into(v, saved[k]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_write_into(t, s)
                            for t, s in zip(target, saved))
    return _plain(saved)


def _restore_into(target: Any, saved: Any) -> Any:
    """Check the whole of ``saved`` against ``target``, then write it: a
    checkpoint that does not fit raises before any tensor of the live
    state is touched."""
    _check_into(target, saved, "state")
    return _write_into(target, saved)


def host_snapshot(state: Any) -> Any:
    """A host copy of ``state`` that :func:`load_snapshot` restores in
    place, as a checkpoint would be (the supervisor's fresh start)."""
    return _HostCopier()(_pack(state))


def load_snapshot(state_like: Any, snapshot: Any) -> Any:
    """Restore a :func:`host_snapshot` into ``state_like``, by the rules of
    :meth:`Checkpointer.restore`."""
    return _restore_into(state_like, snapshot)


# ---- the checkpointer ------------------------------------------------------


class Checkpointer:
    """Per-step ``torch.save`` directories with manifests and a ladder."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3,
                 default_layout: dict | None = None, recorder=None, *,
                 sharded: bool = False):
        """``default_layout``: layout-identity dict applied to every
        save/restore that doesn't pass ``layout=`` (hook-driven saves and
        ``run_with_recovery`` restores never see the model).
        ``sharded``: every rank saves and restores its own part of the
        state (FSDP shards); otherwise rank 0 writes for all."""
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self.default_layout = default_layout
        self.sharded = sharded
        self.rec = recorder if recorder is not None else obs_events.current()
        self._copier = _HostCopier()
        self._pending_step: int | None = None
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None
        self._written: dict[str, tuple[int, int]] = {}  # name -> size, crc
        self.cleaned_on_start = (self._clean_stale_tmp() if _is_writer()
                                 else [])
        self.directory.mkdir(parents=True, exist_ok=True)

    # ---- startup hygiene ---------------------------------------------------

    def _clean_stale_tmp(self) -> list[str]:
        """Remove kill-mid-save debris: uncommitted ``<step>.ckpt-tmp``
        directories and half-written manifest tmp files."""
        if not self.directory.is_dir():
            return []
        removed = []
        for p in self.directory.iterdir():
            name = p.name
            if p.is_dir() and _TMP_SUFFIX in name:
                shutil.rmtree(p, ignore_errors=True)
                removed.append(name)
            elif (p.is_file() and name.startswith("manifest_")
                  and name.endswith(_MANIFEST_TMP_SUFFIX)):
                p.unlink(missing_ok=True)
                removed.append(name)
        if removed:
            log.warning(
                "checkpoint startup hygiene: removed %d stale tmp "
                "artifact(s) left by an interrupted save under %s: %s",
                len(removed), self.directory, sorted(removed))
        return removed

    # ---- save --------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(step)

    def _tmp_dir(self, step: int) -> Path:
        return self.directory / f"{step}{_TMP_SUFFIX}"

    def _state_file(self, rank: int) -> str:
        return f"state_rank{rank}.pt" if self.sharded else "state.pt"

    def save(self, step: int, state: Any, *,
             layout: dict | None = _UNSET, async_: bool = False) -> bool:
        """Save ``state`` as step ``step``; False if that step exists
        (labels are immutable step counts). ``layout``: a layout-identity
        dict written as a sidecar and checked at restore (unspecified:
        ``default_layout``; ``None``: none). ``async_=True`` returns once
        the state is copied to host; serialisation runs in a background
        thread and the commit waits for the next barrier."""
        if layout is _UNSET:
            layout = self.default_layout
        self._commit_pending()
        if step in self._committed_steps():
            return False
        rank, world = _rank_world()
        writes = self.sharded or rank == 0
        tmp = self._tmp_dir(step)
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            (tmp / _META).write_text(json.dumps(
                {"world_size": world, "sharded": self.sharded,
                 "format": "torch.save"}))
            self._write_sidecar(step, layout)
        _barrier()
        host = self._copier(_pack(state)) if writes else None
        path = tmp / self._state_file(rank)

        def write():
            try:
                if host is not None:
                    with path.open("wb") as fh:
                        sink = _CrcWriter(fh)
                        torch.save(host, sink)
                    self._written[path.name] = (sink.size, sink.crc)
            except BaseException as e:  # surfaced at the commit barrier
                self._writer_error = e

        self._pending_step = step
        if async_:
            self._writer = threading.Thread(
                target=write, name=f"ckpt-writer-{step}", daemon=True)
            self._writer.start()
            log.info("async checkpoint at step %d enqueued -> %s", step,
                     self.directory)
        else:
            write()
            self._commit_pending()
            log.info("saved checkpoint at step %d -> %s", step,
                     self.directory)
        if self.rec.enabled:
            self.rec.emit("ckpt.save", cat="train", actor="checkpointer",
                          payload={"step": int(step), "async": bool(async_)})
        return True

    def _commit_pending(self) -> None:
        """The commit barrier: join the background write (re-raising its
        error here), rename the step's directory into place and only then
        write the manifest that marks the step valid."""
        if self._pending_step is None:
            return
        step, self._pending_step = self._pending_step, None
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err
        _barrier()
        if _is_writer():
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(self._tmp_dir(step), final)
            self._write_manifest(step)
            self._gc()
        _barrier()
        log.info("checkpoint at step %d committed", step)

    def _write_sidecar(self, step: int, layout: dict | None) -> None:
        sidecar = self.directory / f"layout_{step}.json"
        if layout is not None:
            sidecar.write_text(json.dumps(layout, sort_keys=True))
        else:
            # a layout-less save must invalidate any orphaned sidecar
            # from an earlier run that reused this step number
            sidecar.unlink(missing_ok=True)

    def _manifest_path(self, step: int) -> Path:
        return self.directory / f"manifest_{step}.json"

    def _write_manifest(self, step: int) -> None:
        """Per-file size+CRC32 manifest, written atomically AFTER the
        payload: manifest present => every payload byte it lists was on
        disk."""
        step_dir = self._step_dir(step)
        written, self._written = self._written, {}
        files = {}
        for p in sorted(step_dir.rglob("*")):
            if not p.is_file():
                continue
            size, crc = written.get(p.name, (None, None))
            if size != p.stat().st_size:  # another rank's file, or meta
                size, crc = p.stat().st_size, _crc32(p)
            files[str(p.relative_to(step_dir))] = [size, crc]
        target = self._manifest_path(step)
        tmp = target.with_name(target.name + _MANIFEST_TMP_SUFFIX)
        tmp.write_text(json.dumps({"step": step, "files": files}))
        os.replace(tmp, target)

    def _gc(self) -> None:
        """Keep the newest ``max_to_keep`` steps; drop the sidecars and
        manifests of the steps that went (a stale ``layout_<n>.json``
        would poison a later run reusing step n)."""
        steps = self._committed_steps()
        for old in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        live = set(self._committed_steps())
        for prefix in ("layout_", "manifest_"):
            for p in self.directory.glob(f"{prefix}*.json"):
                try:
                    n = int(p.stem.removeprefix(prefix))
                except ValueError:  # pragma: no cover - foreign file
                    continue
                if n not in live:
                    p.unlink(missing_ok=True)

    # ---- verify / restore --------------------------------------------------

    def _committed_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        self._commit_pending()
        return self._committed_steps()

    def verify_step(self, step: int) -> bool:
        """True iff the step's payload matches its manifest (size + CRC32
        per file). A committed step without a manifest (an older writer)
        is unverifiable and passes; the ladder's restore still guards
        it."""
        step_dir = self._step_dir(step)
        if not step_dir.is_dir():
            return False
        mpath = self._manifest_path(step)
        if not mpath.exists():
            return True
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, json.JSONDecodeError):
            return False
        for rel, (size, crc) in manifest.get("files", {}).items():
            p = step_dir / rel
            if not p.is_file() or p.stat().st_size != size:
                log.warning("checkpoint step %d: %s missing or truncated",
                            step, rel)
                return False
            if _crc32(p) != crc:
                log.warning("checkpoint step %d: %s fails CRC32", step, rel)
                return False
        return True

    def _check_layout(self, step: int, layout: dict | None) -> None:
        if layout is None:
            return
        sidecar = self.directory / f"layout_{step}.json"
        if sidecar.exists():
            saved = json.loads(sidecar.read_text())
            if saved != layout:
                raise LayoutMismatchError(
                    f"checkpoint layout mismatch at step {step}: saved "
                    f"{saved}, restoring model expects {layout} — same "
                    "tree shapes do NOT imply the same layer order "
                    "(e.g. interleaved virtual-chunk stacks)")

    def _load(self, step: int) -> Any:
        step_dir = self._step_dir(step)
        rank, world = _rank_world()
        meta_path = step_dir / _META
        meta = (json.loads(meta_path.read_text()) if meta_path.exists()
                else {"world_size": 1, "sharded": False})
        if meta.get("sharded") and meta["world_size"] != world:
            raise WorldSizeMismatchError(
                f"checkpoint step {step} holds {meta['world_size']} "
                f"rank shards; this run has {world} ranks — restore with "
                "the world size it was saved with")
        name = (f"state_rank{rank}.pt" if meta.get("sharded")
                else "state.pt")
        return torch.load(step_dir / name, map_location="cpu",
                          weights_only=True)

    def restore(self, state_like: Any, step: int | None = None, *,
                layout: dict | None = _UNSET) -> Any:
        """Restore into ``state_like`` (see the module docstring: state
        objects in place, plain trees as new values on the state's
        devices). ``state_like=None`` restores as saved (numpy arrays as
        numpy, tensors on the CPU): the serving engine's snapshot blob
        rides this path. ``layout`` is checked against the step's
        sidecar (unspecified: ``default_layout``; ``None``: skipped)."""
        if layout is _UNSET:
            layout = self.default_layout
        self._commit_pending()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        self._check_layout(step, layout)
        saved = self._load(step)
        if state_like is None:
            return _plain(saved)
        return _restore_into(state_like, saved)

    def restore_latest_valid(
        self, state_like: Any, *, layout: dict | None = _UNSET
    ) -> tuple[Any, int] | None:
        """The restore ladder: walk checkpoints newest→oldest, skip any that
        fail manifest verification or raise during restore, return
        ``(state, step)`` from the newest valid one, or ``None`` when
        nothing restorable exists (the caller starts fresh). A layout,
        world-size or state mismatch is a configuration error, not
        corruption, and re-raises."""
        self._commit_pending()
        steps = sorted(self._committed_steps(), reverse=True)
        skipped: list[int] = []
        for step in steps:
            if not self.verify_step(step):
                skipped.append(step)
                continue
            try:
                state = self.restore(state_like, step=step, layout=layout)
            except (LayoutMismatchError, WorldSizeMismatchError,
                    StateMismatchError):
                raise
            except Exception as e:  # corrupt payload the manifest missed
                log.warning("checkpoint step %d failed to restore (%s)",
                            step, e)
                skipped.append(step)
                continue
            if skipped:
                log.warning(
                    "restore ladder: skipped corrupt/invalid step(s) %s, "
                    "restored step %d from %s",
                    skipped, step, self.directory)
            if self.rec.enabled:
                self.rec.emit("ckpt.restore", cat="train",
                              actor="checkpointer",
                              payload={"step": int(step),
                                       "skipped": [int(s) for s in skipped]})
            return state, step
        if skipped:
            log.error(
                "restore ladder: ALL checkpoint step(s) %s under %s are "
                "corrupt/invalid — degrading to a fresh start",
                skipped, self.directory)
        if self.rec.enabled:
            self.rec.emit("ckpt.restore_miss", cat="train",
                          actor="checkpointer",
                          payload={"skipped": [int(s) for s in skipped]})
        return None

    def wait(self) -> None:
        self._commit_pending()

    def close(self) -> None:
        self._commit_pending()


class CheckpointHook(BaseHook):
    """Save every N steps + at end (CheckpointSaverHook equivalent).

    ``async_save=True`` makes the periodic saves asynchronous: the step
    pays only the copy to host, and durability is settled at the next
    save's barrier (or the final sync save in ``end``). The end-of-run
    save is always synchronous."""

    def __init__(self, checkpointer: Checkpointer, every_steps: int = 1000,
                 *, async_save: bool = False):
        self.ckpt = checkpointer
        self.every_steps = every_steps
        self.async_save = async_save
        self._loop = None

    def begin(self, loop) -> None:
        self._loop = loop

    def after_step(self, step: int, metrics) -> None:
        # labels are completed-step counts, so resuming with
        # start_step=latest_step() never replays an applied update
        done = step + 1
        if done % self.every_steps == 0:
            self.ckpt.save(done, self._loop.state, async_=self.async_save)

    def end(self, step: int) -> None:
        self.ckpt.save(step, self._loop.state)
        self.ckpt.wait()
