"""The census every analysis rule is built on: a runtime record of the
aten ops one program executes.

PyTorch has no jaxpr to walk, so the JAX package's walker becomes a
recorder. :func:`record` runs the program once under a
``TorchDispatchMode`` and keeps, for each op, its name (the
``func.overloadpacket`` spelling: ``mm``, ``_local_scalar_dense``;
``c10d.allreduce_`` outside ``aten``), the dtype, shape and storage of
each input and output tensor, the storages it writes, and its position in
the order the ops ran. Storages are numbered in order of first sight; a
finalizer on each storage a program allocates marks where it was freed,
which the peak-live scan reads (``analysis/cost.py``).

How this census differs from the JAX one:

* It counts EXECUTED ops: an op inside a Python loop counts each time it
  runs, as ``collectives.CommTrace`` counts collectives. The JAX census
  counts a site once (a ``lax.scan`` body is one equation).
* The dispatch mode sees the ops below autograd, so a backward run inside
  the program is recorded too.
* Kernel nodes: every kernel wrapper of ``ops/decode_attention.py`` (K5,
  K6) and ``ops/flash_attention.py`` (K1-K4) is decorated with
  :func:`kernel_entry`. In an active census it records ONE node (the
  kernel's name, operands, outputs, regime and the attributes its cost
  model reads) and suspends recording inside itself: on the card the
  wrapper launches a CUDA kernel the dispatch mode cannot see, on the CPU
  it runs the plain version, whose aten ops would swamp the census. So
  the census of a kernel call is the same on the CPU and on the card.
* CUDA-graph replays bypass Python, so a program is audited through its
  eager body: the serve engine's ``StepFns.decode_fn`` / ``prefill_fn``
  are the steps its graphs capture.
* Collectives are read from ``collectives.CommTrace``, which is open for
  the whole run. A ``c10d`` / ``_c10d_functional`` op the dispatch mode
  sees while ``collectives.py`` is not issuing one is recorded in
  :attr:`Census.bypass`: a collective that went around the
  communication layer.
* Blind spot: on the CPU, ``.cpu()`` and ``.numpy()`` of a CPU tensor
  dispatch nothing, so a device-to-host copy shows only when the program
  runs on the card.

Import discipline: ``torch`` only at module import; the collectives
module is imported when a census runs.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import math
import re
import weakref
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the censuses being recorded, innermost last; process-wide because a CUDA
# backward (and the kernel wrappers it calls) runs on autograd's own thread
_ACTIVE: list["Census"] = []
_WARMED: list[bool] = []


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """One tensor an op read or produced."""

    dtype: torch.dtype
    shape: tuple[int, ...]
    sid: int  # the census's number for its storage
    device: str  # "cpu", "cuda"
    whole: bool  # spans its whole storage

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize


@dataclasses.dataclass
class OpNode:
    """One executed op (``kind="op"``) or kernel call (``kind="kernel"``)."""

    index: int
    name: str
    kind: str
    inputs: list[TensorMeta]
    outputs: list[TensorMeta]
    writes: frozenset[int]  # storages the op mutates
    reads: frozenset[int]  # storages whose values the op consumes
    new: frozenset[int]  # storages the op allocated
    regime: str | None = None
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StorageInfo:
    sid: int
    nbytes: int
    device: str
    alloc: int | None  # node index, -1 for a program input, None: external
    free: int | None = None  # number of nodes recorded when it was freed


def arg_leaves(arg) -> list[torch.Tensor]:
    """The tensors of one program argument, in order: a tensor; a module's
    parameters and buffers; the values of a dict, list or tuple (nested).
    Anything else (numpy arrays, Python numbers) holds none."""
    if isinstance(arg, torch.Tensor):
        return [arg]
    if isinstance(arg, torch.nn.Module):
        return ([p for _, p in arg.named_parameters()]
                + [b for _, b in arg.named_buffers()])
    if isinstance(arg, dict):
        return [t for v in arg.values() for t in arg_leaves(v)]
    if isinstance(arg, (list, tuple)):
        return [t for v in arg for t in arg_leaves(v)]
    return []


def _storage(t: torch.Tensor):
    if t.layout != torch.strided or t.device.type == "meta":
        return None
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


#: random draws that take the global generator unless given one
RANDOM_OPS = frozenset({
    "uniform_", "normal_", "normal", "bernoulli_", "bernoulli",
    "exponential_", "geometric_", "log_normal_", "cauchy_", "random_",
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "multinomial", "native_dropout", "poisson",
    "_standard_gamma",
})


#: in-place ops that overwrite what they write without reading it
WRITE_ONLY = frozenset({
    "copy_", "zero_", "fill_", "index_put_", "index_copy_", "scatter_",
    "masked_fill_", "masked_scatter_", "set_", "resize_", "uniform_",
    "normal_", "bernoulli_", "exponential_", "random_", "geometric_",
    "log_normal_", "cauchy_",
})


class Census:
    """What one run of a program did (see the module docstring)."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.nodes: list[OpNode] = []
        self.storages: dict[int, StorageInfo] = {}
        self.arg_sids: list[list[int]] = []
        self.arg_metas: list[list[TensorMeta]] = []
        self.arg_ptrs_before: list[list[int]] = []
        self.arg_ptrs_after: list[list[int]] = []
        self.origin: dict[int, torch.dtype] = {}  # narrow origin of a widening
        self.comm = None  # collectives.CommTrace of the run
        self.bypass: list[int] = []  # c10d ops outside collectives.py
        self._ids: dict[int, int] = {}  # id(storage object) -> sid
        self._suspended = 0
        self._closed = False

    # ---- storages -------------------------------------------------------------

    def _on_free(self, key: int, sid: int) -> None:
        if self._ids.get(key) == sid:
            del self._ids[key]
        if not self._closed:
            self.storages[sid].free = len(self.nodes)

    def _sid(self, t: torch.Tensor, alloc: int | None) -> tuple[int, bool]:
        """(sid, new) of ``t``'s storage; a storage seen for the first time
        is registered as allocated at ``alloc``."""
        st = _storage(t)
        if st is None:
            sid = len(self.storages)
            self.storages[sid] = StorageInfo(sid, 0, t.device.type, None)
            return sid, False
        key = id(st)
        sid = self._ids.get(key)
        if sid is not None:
            return sid, False
        sid = len(self.storages)
        self._ids[key] = sid
        self.storages[sid] = StorageInfo(sid, st.nbytes(), t.device.type,
                                         alloc)
        weakref.finalize(st, self._on_free, key, sid)
        return sid, True

    def _meta(self, t: torch.Tensor, alloc: int | None) -> tuple[TensorMeta,
                                                                  bool]:
        sid, new = self._sid(t, alloc)
        nbytes = t.numel() * t.element_size()
        return TensorMeta(t.dtype, tuple(t.shape), sid, t.device.type,
                          nbytes == self.storages[sid].nbytes), new

    def _register_args(self, args) -> None:
        for arg in args:
            metas, sids = [], []
            for t in arg_leaves(arg):
                m, _ = self._meta(t, -1)
                self.storages[m.sid].alloc = -1
                metas.append(m)
                if m.sid not in sids:
                    sids.append(m.sid)
            self.arg_metas.append(metas)
            self.arg_sids.append(sids)
            self.arg_ptrs_before.append(
                [t.data_ptr() for t in arg_leaves(arg)])

    # ---- recording ------------------------------------------------------------

    def _record_op(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns != "aten":
            name = f"{ns}.{name}"
        i = len(self.nodes)
        inputs = [self._meta(t, None)[0]
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)]
        writes: set[int] = set()
        attrs: dict = {}
        for k, a in enumerate(func._schema.arguments):
            v = args[k] if k < len(args) else kwargs.get(a.name)
            if a.alias_info is not None and a.alias_info.is_write:
                writes.update(self._sid(t, None)[0]
                              for t in tree_flatten(v)[0]
                              if isinstance(t, torch.Tensor))
            if a.name == "generator":
                attrs["global_generator"] = v is None
            if a.name == "dim" and isinstance(v, (int, list, tuple)):
                attrs["dim"] = v
        outputs, new = [], set()
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                m, is_new = self._meta(t, i)
                outputs.append(m)
                if is_new:
                    new.add(m.sid)
        out_sids = {m.sid for m in outputs}
        # a view's output shares its input's storage: not a read; an
        # in-place op reads what it writes unless it only overwrites it
        blind = writes if name in WRITE_ONLY else set()
        reads = frozenset(m.sid for m in inputs if m.sid not in blind and (
            m.sid in writes or m.sid not in out_sids))
        if name in RANDOM_OPS and "global_generator" not in attrs:
            attrs["global_generator"] = True
        self._note_widening(name, inputs, outputs)
        if ns in ("c10d", "_c10d_functional"):
            from distributed_tensorflow_guide_tpu_torch.collectives import (
                collectives as cc,
            )

            if not cc.issuing():
                self.bypass.append(i)
        self.nodes.append(OpNode(i, name, "op", inputs, outputs,
                                 frozenset(writes), reads, frozenset(new),
                                 attrs=attrs))

    def _note_widening(self, name, inputs, outputs) -> None:
        """A copy into a wider dtype remembers the narrowest dtype the
        value had (``origin``): a product of widened operands is read at
        that width (cost) and, when all its operands share one narrow
        origin, is a product in that dtype (precision)."""
        if name == "_to_copy" and inputs and outputs:
            src, dst = inputs[0], outputs[0]
        elif name == "copy_" and len(inputs) >= 2:
            dst, src = inputs[0], inputs[1]
            if not dst.whole:
                return
        else:
            return
        was = self.origin.get(src.sid, src.dtype)
        if dst.dtype.itemsize > was.itemsize:
            self.origin[dst.sid] = was
        else:
            self.origin.pop(dst.sid, None)

    def _record_kernel(self, name, regime, inputs, out, attrs,
                       writes=()) -> None:
        i = len(self.nodes)
        ins = [self._meta(t, None)[0] for t in inputs
               if isinstance(t, torch.Tensor)]
        outputs, new = [], set()
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                m, is_new = self._meta(t, i)
                outputs.append(m)
                if is_new:
                    new.add(m.sid)
        w = frozenset(self._sid(t, None)[0] for t in writes)
        self.nodes.append(OpNode(
            i, name, "kernel", ins, outputs, w,
            frozenset(m.sid for m in ins), frozenset(new), regime,
            dict(attrs)))

    def close(self, args) -> None:
        self.arg_ptrs_after = [[t.data_ptr() for t in arg_leaves(a)]
                               for a in args]
        self._closed = True

    # ---- derived facts ----------------------------------------------------------

    def counts(self) -> dict:
        """Ops and kernel nodes recorded."""
        return {"ops": sum(n.kind == "op" for n in self.nodes),
                "kernel_nodes": sum(n.kind == "kernel" for n in self.nodes)}

    def last_use(self) -> dict[int, int]:
        """sid -> index of the last node that read or wrote it."""
        out: dict[int, int] = {}
        for n in self.nodes:
            for s in n.reads | n.writes:
                out[s] = n.index
        return out


class _Recorder(TorchDispatchMode):
    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference mode a composite op (linear, to, reshape) reaches
        # the mode whole: run its decomposition with the mode on, so the
        # census holds the ops it is made of, as it does under autograd
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self.census._suspended:
            self.census._record_op(func, args, kwargs, out)
        return out


def record(fn: Callable, args: tuple, *, device=None) -> tuple[Any, Census]:
    """Run ``fn(*args)`` once and return (its result, the census)."""
    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )

    if not _WARMED:
        # the first backward a process runs under a dispatch mode holds its
        # loss a little longer than every later one: warm that path up once
        # on a throwaway program, so a census does not depend on whether it
        # is the process's first
        _WARMED.append(True)
        x = torch.ones(2, requires_grad=True)
        record(lambda t: torch.autograd.grad((t * 2).sum() / 3, (t,)), (x,))
    census = Census(None if device is None else torch.device(device))
    census._register_args(args)
    _ACTIVE.append(census)
    # no cycle collection mid-run: a storage freed by the collector would
    # die at a point that depends on the collector's timing, not on the
    # program (cyclic garbage is freed after the run, which counts it live
    # to the end)
    gc_was = gc.isenabled()
    gc.disable()
    try:
        with cc.trace_comm() as comm, _Recorder(census):
            result = fn(*args)
    finally:
        if gc_was:
            gc.enable()
        _ACTIVE.remove(census)
    census.comm = comm
    census.close(args)
    return result, census


def kernel_entry(name: str, describe: Callable) -> Callable:
    """Decorator for a kernel wrapper. In an active census the call is one
    kernel node and records nothing inside; ``describe(*args, **kwargs)``
    returns ``(regime, operands, attrs)`` (operands: the tensors the
    kernel reads), or a 4-tuple adding the tensors it writes in place.
    Outside a census the wrapper runs untouched."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE or _ACTIVE[-1]._suspended:
                return fn(*args, **kwargs)
            census = _ACTIVE[-1]
            regime, operands, attrs, *writes = describe(*args, **kwargs)
            census._suspended += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                census._suspended -= 1
            census._record_kernel(name, regime, operands, out, attrs,
                                  writes[0] if writes else ())
            return out
        return wrapper
    return deco


# ---- census queries -------------------------------------------------------------


def primitive_census(census: Census) -> Counter:
    """op or kernel name -> times executed."""
    return Counter(n.name for n in census.nodes)


#: CommTrace ops spelled as the JAX census spells the primitive (its
#: ``pmean`` lowers to ``psum`` + divide)
_COMM_ALIASES = {"pmean": "psum"}


def census_key(trace_key: str) -> str:
    """A CommTrace key (``"pmean[data]"``) in census spelling."""
    op, _, rest = trace_key.partition("[")
    return f"{_COMM_ALIASES.get(op, op)}[{rest}"


def collective_census(census: Census) -> Counter:
    """``"prim[axis,...]" -> executed calls``, from the run's CommTrace."""
    out: Counter = Counter()
    for key, n in (census.comm.calls.items() if census.comm else ()):
        out[census_key(key)] += n
    return out


def _allocated(census: Census):
    """(node, output) for every output the node allocated: the program's
    intermediates (a view allocates nothing)."""
    for n in census.nodes:
        for m in n.outputs:
            if m.sid in n.new:
                yield n, m


def largest_f32_intermediate(census: Census) -> tuple[int, tuple[int, ...]]:
    """(elements, shape) of the biggest f32 tensor the program allocated."""
    worst, shape = 0, ()
    for _, m in _allocated(census):
        if m.dtype == torch.float32 and m.numel > worst:
            worst, shape = m.numel, m.shape
    return worst, shape


def max_f32_elems_with_vocab_dim(census: Census, n: int, v: int) -> int:
    """Largest f32 tensor of shape (..., V) with >= n rows the program
    allocated: the fused-CE "no full logits" instrument."""
    worst = 0
    for _, m in _allocated(census):
        if (m.dtype == torch.float32 and len(m.shape) >= 2
                and m.shape[-1] == v and math.prod(m.shape[:-1]) >= n):
            worst = max(worst, m.numel)
    return worst


def input_use_counts(census: Census) -> list[list[int]]:
    """Per argument, per storage of it: the nodes that read it."""
    reads = Counter(s for n in census.nodes for s in n.reads)
    return [[reads[s] for s in sids] for sids in census.arg_sids]


def deep_input_used(census: Census) -> list[list[bool]]:
    """Per argument, per storage of it: is it read by any node."""
    return [[c > 0 for c in counts] for counts in input_use_counts(census)]


_ADDR = re.compile(r"0x[0-9a-f]+")


def _dt(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def render(census: Census) -> str:
    """The census as text, one node a line, storages renumbered in order of
    first appearance: two runs of one program give the same text, and any
    structural drift (a new op, a shape, a dtype, another dataflow) shows
    as a diff. Addresses are normalised away."""
    names: dict[int, str] = {}

    def ref(m: TensorMeta) -> str:
        if m.sid not in names:
            names[m.sid] = f"%{len(names)}"
        return f"{names[m.sid]}:{_dt(m.dtype)}{list(m.shape)}"

    for sids in census.arg_sids:
        for s in sids:
            names.setdefault(s, f"%{len(names)}")
    lines = []
    for n in census.nodes:
        ins = ", ".join(ref(m) for m in n.inputs)
        outs = ", ".join(ref(m) for m in n.outputs)
        tag = f" [{n.regime}]" if n.regime else ""
        kind = "kernel " if n.kind == "kernel" else ""
        lines.append(f"{kind}{n.name}{tag}({ins}) -> ({outs})")
    return _ADDR.sub("0x•", "\n".join(lines))


def traced_text(fn: Callable, *args) -> str:
    """The rendered census of ``fn(*args)``: the byte-identity instrument
    (two code paths that must run the same program compare equal)."""
    return render(record(fn, args)[1])
