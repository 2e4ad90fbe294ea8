"""CUDA-graph capture of a step function over static buffers.

The JAX package compiles each serving step once (``jax.jit``) and runs the
compiled program at every step. Here a step is captured once as a CUDA
graph whose inputs live in static device buffers: every later step writes
its inputs into those buffers and replays the graph, so the host launches
one graph where it launched a few hundred kernels. The reference's rule
"zero new compiles" becomes "zero recaptures": a :class:`CapturedStep`
captures on its first call and never again, and a capture that fails
raises, then and at every later call (no eager fallback on the card).

What a graph holds by address — its static inputs, the model's weights,
the KV cache or pool, LoRA banks — must never be reallocated; writing new
values into them in place is what they are for.

Kernel launch counters (``ops.decode_attention.LAUNCHES`` and
``REGIME_LAUNCHES``, ``ops.flash_attention.LAUNCHES``) live in the kernels'
Python wrappers, so a kernel inside a graph counts when it is captured,
not when it runs. :class:`CapturedStep` keeps the counts true: what its
warm-up and its capture counted is taken back, and every replay adds the
launches the capture recorded.
"""

from __future__ import annotations

import torch


def _counters() -> list[dict]:
    from distributed_tensorflow_guide_tpu_torch.ops import (
        decode_attention as DA,
    )
    from distributed_tensorflow_guide_tpu_torch.ops import (
        flash_attention as FA,
    )

    return [DA.LAUNCHES, DA.REGIME_LAUNCHES, FA.LAUNCHES]


def _snapshot() -> list[dict]:
    return [dict(c) for c in _counters()]


class CapturedStep:
    """``fn()`` captured once as a CUDA graph and replayed at each call.

    ``fn`` takes no arguments: it reads its inputs from static device
    tensors that the caller fills before each call, and returns its output
    (a tensor or a tuple of them, which every replay rewrites in place).
    The first call warms ``fn`` up with one eager run on a side stream (so
    the allocator and the libraries settle), captures it, and replays it;
    the warm-up's effects must be harmless (idempotent on the caller's
    state, or overwritten before they are read). ``captures`` counts the
    captures, one over the object's life.
    """

    def __init__(self, fn, *, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.out = None
        self.captures = 0
        self.launches: list[dict] = []  # per replay, as the counters hold
        self._error: BaseException | None = None

    def capture(self) -> None:
        if self.graph is not None:
            raise RuntimeError("this step is captured already")
        if self._error is not None:
            raise RuntimeError("the capture of this step failed before"
                               ) from self._error
        before = _snapshot()
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            warmed = _snapshot()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.fn()
            captured = _snapshot()
        except BaseException as exc:
            self._error = exc
            raise
        finally:
            for counter, old in zip(_counters(), before):
                counter.update(old)
        self.launches = [{k: captured[i][k] - warmed[i][k] for k in c}
                         for i, c in enumerate(captured)]
        self.graph, self.out = graph, out
        self.captures += 1

    def __call__(self):
        if self.graph is None:
            self.capture()
        self.graph.replay()
        for counter, added in zip(_counters(), self.launches):
            for k, n in added.items():
                counter[k] += n
        return self.out
