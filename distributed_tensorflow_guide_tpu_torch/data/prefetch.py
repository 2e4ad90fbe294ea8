"""Device prefetch and batch packing: the input half of the k-step train
step.

The JAX package's ``data/prefetch.py`` (``tf.data``'s
``prefetch_to_device``). There ``jax.device_put`` is asynchronous, so a
bounded lookahead of puts hides the transfer. Here the same lookahead
copies each host batch into pinned host memory and from there to the card
with a non-blocking copy on a side CUDA stream; an event recorded after
the copy is what the consumer's stream waits on before it reads the batch,
so the transfer of batch N+1 runs while step N computes.

* :func:`pack_batches` stacks k host batches into one ``steps_per_call``
  super-batch (leading axis = inner step), the layout of
  ``DataParallel.make_train_step(steps_per_call=k, stacked_batch=True)``;
  :func:`pack_stream` packs a stream, with ``drop_remainder`` for a short
  tail.
* :class:`DevicePrefetchIterator` keeps up to ``depth`` batches on the
  device ahead of the consumer, with :class:`PrefetchStats` accounting.
* :func:`prefetch_to_device` assembles both.

A batch is a tensor or numpy array, or a dict / list / tuple of them
(nested). The iterator drops its own reference to a batch before it
yields it: nothing here reads a yielded batch again, so the consumer may
write into it. ``max_host_wait_s`` bounds one upstream fetch: a slower one
raises the watchdog's :class:`~..utils.watchdog.DataStallError` (a
recoverable ``RuntimeError``), and the worst fetch is recorded either way.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from collections.abc import Mapping
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.utils.watchdog import (
    DataStallError,
)


@dataclasses.dataclass
class PrefetchStats:
    """Host-side accounting of one prefetch stream: ``host_wait_s`` in the
    upstream iterator, ``put_s`` issuing the copies (not completing them),
    ``peak_ahead`` the most batches resident ahead of the consumer,
    ``max_host_wait_s`` the worst single upstream fetch."""

    batches: int = 0
    host_wait_s: float = 0.0
    put_s: float = 0.0
    peak_ahead: int = 0
    max_host_wait_s: float = 0.0

    def as_dict(self) -> dict:
        return {
            "prefetch_batches": self.batches,
            "prefetch_host_wait_s": round(self.host_wait_s, 4),
            "prefetch_put_s": round(self.put_s, 4),
            "prefetch_peak_ahead": self.peak_ahead,
            "prefetch_max_host_wait_s": round(self.max_host_wait_s, 4),
        }


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure dicts / lists / tuples."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _stack(*xs):
    if any(torch.is_tensor(x) for x in xs):
        return torch.stack([torch.as_tensor(x) for x in xs])
    return np.stack(xs)


def pack_batches(batches: list) -> Any:
    """Stack k same-structure host batches along a new leading axis:
    leaves (k, per-step batch, ...), one slice an inner step. Stacked on
    the host, so the pack crosses to the card as one copy."""
    if not batches:
        raise ValueError("pack_batches needs at least one batch")
    return tree_map(_stack, *batches)


def pack_stream(source: Iterable, steps_per_call: int,
                *, drop_remainder: bool = True) -> Iterator[Any]:
    """``source`` in packs of ``steps_per_call`` stacked batches. A tail
    shorter than that is dropped (``drop_remainder=True``) or yielded as a
    short pack (the train loop's ``tail_step_fn`` runs its stragglers)."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    it = iter(source)
    while True:
        pack: list = []
        for _ in range(steps_per_call):
            try:
                pack.append(next(it))
            except StopIteration:
                break
        if len(pack) == steps_per_call:
            yield pack_batches(pack)
        else:
            if pack and not drop_remainder:
                yield pack_batches(pack)
            return


class DevicePrefetchIterator:
    """Up to ``depth`` batches resident on ``device`` ahead of the
    consumer (2: double buffering; 3 also rides out one slow host batch).

    ``device=None`` is this rank's CUDA card (raises without one); on the
    CPU a batch is its tensors. On the card each batch is copied into
    pinned host memory, then to the card with ``non_blocking`` copies on a
    side stream, followed by an event; :meth:`__next__` makes the current
    stream wait on that event (and records the batch's tensors on it for
    the allocator) before it hands the batch over. ``put_fn`` replaces the
    whole placement (then no stream or event is involved).

    The refill runs on every ``__next__``: pop the head, then top the
    buffer up, so the next copies are issued before the consumer launches
    its step. ``max_host_wait_s``: a fetch from ``source`` slower than this
    raises :class:`~..utils.watchdog.DataStallError` (fail-fast: the error
    preempts the batches already buffered); it catches slow fetches that
    return, where the loop's ``data_deadline_s`` catches ones that hang.
    """

    def __init__(self, source: Iterable, *, device=None, depth: int = 2,
                 put_fn: Callable[[Any], Any] | None = None,
                 max_host_wait_s: float | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if max_host_wait_s is not None and max_host_wait_s <= 0:
            raise ValueError(
                f"max_host_wait_s must be > 0, got {max_host_wait_s}")
        self.max_host_wait_s = max_host_wait_s
        self._src = iter(source)
        self.depth = depth
        self.stats = PrefetchStats()
        self._put_fn = put_fn
        self.device = None if put_fn is not None else resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None
                        and self.device.type == "cuda" else None)
        self._buf: deque = deque()
        self._exhausted = False

    def _put(self, host_batch):
        """(batch on the device, the event its copies end at or None)."""
        if self._put_fn is not None:
            return self._put_fn(host_batch), None
        if self._stream is None:
            return tree_map(lambda x: torch.as_tensor(x).to(self.device),
                            host_batch), None
        pinned = tree_map(lambda x: torch.as_tensor(x).pin_memory(),
                          host_batch)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            batch = tree_map(lambda t: t.to(self.device, non_blocking=True),
                             pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        return batch, done

    def _fill(self) -> None:
        while len(self._buf) < self.depth and not self._exhausted:
            t0 = time.perf_counter()
            try:
                host_batch = next(self._src)
            except StopIteration:
                self._exhausted = True
                return
            t1 = time.perf_counter()
            self.stats.host_wait_s += t1 - t0
            self.stats.max_host_wait_s = max(self.stats.max_host_wait_s,
                                             t1 - t0)
            if (self.max_host_wait_s is not None
                    and t1 - t0 > self.max_host_wait_s):
                raise DataStallError(
                    f"data iterator stalled: one fetch took "
                    f"{t1 - t0:.2f}s > max_host_wait_s="
                    f"{self.max_host_wait_s:g}s "
                    f"(after {self.stats.batches} batches)")
            self._buf.append(self._put(host_batch))
            self.stats.put_s += time.perf_counter() - t1
            self.stats.peak_ahead = max(self.stats.peak_ahead,
                                        len(self._buf))

    def __iter__(self) -> "DevicePrefetchIterator":
        return self

    def __next__(self) -> Any:
        self._fill()
        if not self._buf:
            raise StopIteration
        batch, done = self._buf.popleft()
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in tree_leaves(batch):
                t.record_stream(current)
        self.stats.batches += 1
        # refill now, so the next copies are in flight before the caller
        # launches its step
        self._fill()
        return batch


def prefetch_to_device(source: Iterable, *, device=None, depth: int = 2,
                       put_fn: Callable[[Any], Any] | None = None,
                       steps_per_call: int = 1,
                       drop_remainder: bool = True) -> DevicePrefetchIterator:
    """Host batches in, device batches out, in order; with
    ``steps_per_call > 1`` :func:`pack_stream` runs upstream, so each item
    is one stacked super-batch for the k-step train step."""
    if steps_per_call > 1:
        source = pack_stream(source, steps_per_call,
                             drop_remainder=drop_remainder)
    return DevicePrefetchIterator(source, device=device, depth=depth,
                                  put_fn=put_fn)
