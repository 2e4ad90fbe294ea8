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
capture counted is taken back (and, for a serving step, what its warm-up
counted), and every replay adds the launches the capture recorded.

Train steps (``steps_per_call``, :class:`MultiStep`): a train step is not
idempotent, so its capture runs with ``train=True``: the first call's
eager run (the warm-up) IS the first call's result and its launches
count, the capture records without running, and the second call is the
first replay. Autograd runs inside the capture (no ``inference_mode``);
the optimizer must keep its step counter on the card (``torch.optim.Adam``
/ ``AdamW`` with ``capturable=True``), and a learning rate that a host
schedule moves between calls must be a device tensor written in place.
"""

from __future__ import annotations

import contextlib
import gc

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


@contextlib.contextmanager
def _no_gc():
    """Python's cycle collector off while a graph captures:
    ``torch.cuda.graph`` collects before the capture begins, and a
    collection that fires mid-capture (the capture allocates many Python
    objects) would run the finalizers of dead graphs and pinned buffers,
    whose CUDA calls are not permitted while a stream captures and
    invalidate the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class CapturedStep:
    """``fn()`` captured once as a CUDA graph and replayed at each call.

    ``fn`` takes no arguments: it reads its inputs from static device
    tensors that the caller fills before each call, and returns its output
    (a tensor or a tuple of them, which every replay rewrites in place).
    The first call warms ``fn`` up with one eager run on a side stream (so
    the allocator and the libraries settle), captures it, and replays it;
    the warm-up's effects must be harmless (idempotent on the caller's
    state, or overwritten before they are read). With ``train=True`` the
    warm-up is the first call: its output is returned and nothing is
    replayed until the second call, so a step that moves the caller's
    state (an optimizer step) runs once a call. ``captures`` counts the
    captures, one over the object's life.
    """

    def __init__(self, fn, *, device, train: bool = False):
        self.fn = fn
        self.train = train
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
        warmed = None
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                first = self.fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            warmed = _snapshot()
            graph = torch.cuda.CUDAGraph()
            with _no_gc(), torch.cuda.graph(graph):
                out = self.fn()
            captured = _snapshot()
        except BaseException as exc:
            self._error = exc
            raise
        finally:
            # a train warm-up really ran: its launches stay counted
            keep = warmed if self.train and warmed is not None else before
            for counter, old in zip(_counters(), keep):
                counter.update(old)
        self.launches = [{k: captured[i][k] - warmed[i][k] for k in c}
                         for i, c in enumerate(captured)]
        self.graph, self.out = graph, out
        self.captures += 1
        return first

    def __call__(self):
        if self.graph is None:
            first = self.capture()
            if self.train:
                return first
        self.graph.replay()
        for counter, added in zip(_counters(), self.launches):
            for k, n in added.items():
                counter[k] += n
        return self.out


# ---- k optimizer steps a call ------------------------------------------------


def _lr_marks(optimizer) -> list:
    """What a replay must find unchanged in each param group's learning
    rate: a float's value, or a tensor's identity and version counter
    (an in-place write bumps it, with no read of the card)."""
    if optimizer is None:
        return []
    return [("t", id(lr), lr._version) if torch.is_tensor(lr)
            else ("f", float(lr)) for lr in
            (g["lr"] for g in optimizer.param_groups)]


def check_capturable(optimizer) -> None:
    """Refuse an optimizer whose step cannot live in a CUDA graph: an
    ``Adam`` / ``AdamW`` (or any optimizer with a ``capturable`` flag)
    without ``capturable=True`` keeps its step counter on the host."""
    if optimizer is None:
        return
    for i, g in enumerate(optimizer.param_groups):
        if "capturable" in g and not g["capturable"]:
            raise ValueError(
                f"a captured train step needs its optimizer's step counter "
                f"on the card: build {type(optimizer).__name__}(..., "
                f"capturable=True) (param group {i} has capturable=False)")


class MultiStep:
    """``(state, batch) -> (state, metrics)``: ``k`` optimizer steps of
    ``one_step`` a call — the reference's ``steps_per_call``, whose
    ``lax.scan`` becomes, on the card, one CUDA graph of the k steps.

    ``one_step(state, batch) -> (state, metrics)`` takes a batch already
    on the device. With ``stacked_batch`` every tensor of the batch leads
    with k (one slice an inner step), otherwise the same batch runs k
    times. Metrics are the last inner step's, or with ``per_step_metrics``
    each stacked to (k,). At k = 1 they have no leading axis.

    ``capture=True`` (a CUDA device, no gloo group on the path): the first
    call copies the batch into static device buffers, runs the k steps
    eagerly and captures them (:class:`CapturedStep` with ``train=True``);
    each later call copies its batch in (same shapes and dtypes: no cast)
    and replays. A replay rewrites its outputs, so the metrics returned
    are clones. The graph belongs to the first call's state (its module's
    parameters, its optimizer's moments): another state is refused, and
    so is a learning rate changed between calls where the graph cannot
    follow it (a float, or any change at k > 1: the k steps would run at
    a stale rate). ``eager`` is the same contract without capture; on the
    CPU the step is its eager twin. A host-side step counter
    (``TrainState.step``) moves by k a call.

    ``prepare(batch)`` puts a host batch on the device, ``check(state)``
    validates the state, and every call runs inside ``context()``;
    ``optimizer_of(state)`` is the optimizer the graph steps (the state's
    ``optimizer`` attribute by default).
    """

    def __init__(self, one_step, *, steps_per_call: int, stacked_batch: bool,
                 per_step_metrics: bool, capture: bool, device,
                 prepare=None, check=None, context=None,
                 optimizer_of=None):
        self.check_args(steps_per_call, stacked_batch)
        self.one_step = one_step
        self.k = steps_per_call
        self.stacked = stacked_batch
        self.per_step = per_step_metrics
        self.captured = bool(capture)
        self.device = torch.device(device)
        self.prepare = prepare or (lambda b: b)
        self.check = check or (lambda st: None)
        self.context = context or contextlib.nullcontext
        self.optimizer_of = optimizer_of or (
            lambda st: getattr(st, "optimizer", None))
        self._graph: CapturedStep | None = None
        self._static: dict | None = None
        # what the graph holds: the first call's state, optimizer, batch
        # shapes and dtypes, and each param group's learning-rate mark
        self._state = self._opt = self._shapes = None
        self._lr: list = []

    @staticmethod
    def check_args(steps_per_call, stacked_batch: bool) -> None:
        """The reference's refusals; ``steps_per_call=None`` is the
        one-step call."""
        if steps_per_call is not None and steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        if stacked_batch and (steps_per_call or 1) == 1:
            raise ValueError(
                "stacked_batch requires steps_per_call > 1 (a stacked "
                "batch's leading axis is consumed one slice per inner "
                "step)")

    @property
    def captures(self) -> int:
        return 0 if self._graph is None else self._graph.captures

    def _check_lead(self, batch: dict) -> None:
        if not self.stacked:
            return
        lead = {int(v.shape[0]) for v in batch.values()}
        if lead != {self.k}:
            raise ValueError(
                f"stacked batch leading axis {lead} != "
                f"steps_per_call={self.k}; the scan would silently run a "
                "different number of optimizer steps")

    def run_k(self, state, batch: dict):
        ms = []
        for j in range(self.k):
            b = {n: v[j] for n, v in batch.items()} if self.stacked \
                else batch
            state, m = self.one_step(state, b)
            ms.append(m)
        if self.k == 1:
            return state, ms[0]
        if self.per_step:
            return state, {n: torch.stack([m[n] for m in ms])
                           for n in ms[0]}
        return state, ms[-1]

    def eager(self, state, batch: dict):
        self.check(state)
        batch = self.prepare(batch)
        self._check_lead(batch)
        with self.context():
            return self.run_k(state, batch)

    def __call__(self, state, batch: dict):
        if not self.captured:
            return self.eager(state, batch)
        self.check(state)
        batch = self.prepare(batch)
        self._check_lead(batch)
        with self.context():
            return self._replay(state, batch)

    def _replay(self, state, batch: dict):
        host0 = getattr(state, "step", None)
        opt = self.optimizer_of(state)
        if self._graph is None:
            check_capturable(opt)
            self._bind(state, opt, batch)
            static = self._static
            self._graph = CapturedStep(
                lambda: self.run_k(state, static)[1], device=self.device,
                train=True)
        else:
            self._check_bound(state, opt, batch)
            for n, v in batch.items():
                self._static[n].copy_(v)
        out = self._graph()
        if isinstance(host0, int):
            state.step = host0 + self.k
        return state, {n: v.clone() for n, v in out.items()}

    @staticmethod
    def _shapes_of(batch: dict) -> dict:
        return {n: (v.shape, v.dtype) for n, v in batch.items()}

    def _bind(self, state, opt, batch: dict) -> None:
        self._static = {n: v.clone() for n, v in batch.items()}
        self._state, self._opt = state, opt
        self._shapes, self._lr = self._shapes_of(batch), _lr_marks(opt)

    def _check_bound(self, state, opt, batch: dict) -> None:
        if state is not self._state or opt is not self._opt:
            raise ValueError("this captured step belongs to the state of "
                             "its first call: build a new step for "
                             "another state")
        shapes = self._shapes_of(batch)
        if shapes != self._shapes:
            raise ValueError(
                f"a captured step takes the shapes and dtypes of its first "
                f"batch, {self._shapes}; got {shapes}")
        marks = _lr_marks(opt)
        if marks == self._lr:
            return
        for i, (old, new) in enumerate(zip(self._lr, marks)):
            if old == new:
                continue
            if old[0] == "f" or new[0] == "f" or old[1] != new[1]:
                raise ValueError(
                    f"param group {i}'s learning rate changed between "
                    f"calls of a captured step ({old} -> {new}): the graph "
                    "holds the rate it was captured with. Give the "
                    "optimizer lr=torch.tensor(lr, device=...) and let the "
                    "schedule write it in place")
            if self.k > 1:
                raise ValueError(
                    f"param group {i}'s learning rate was written between "
                    f"calls of a captured step of steps_per_call={self.k}: "
                    "a schedule that moves the rate from the host would "
                    "run all k inner steps at the rate of the call's "
                    "start. Use steps_per_call=1 under such a schedule")
        self._lr = marks
