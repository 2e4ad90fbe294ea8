"""Quantitative cost semantics over a program's census.

The numbers the closed-form models promise are DERIVED from what the
program actually ran, so drift between model and program is a lint
failure instead of a stale doc. Four quantities per program, under the
JAX package's conventions so that a pin means what its pin means:

* **Flops** — the products from their shapes (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``convolution``, ``_int_mm``, ``_scaled_mm``;
  2 flops a multiply-add), plus kernel nodes through the kernel cost
  registry (:func:`register_kernel_cost`). An op in a Python loop counts
  each time it ran, a backward's products are counted as they ran.

* **HBM bytes read/written** — the fusion-boundary model: products,
  gather / index / scatter ops, ``sort`` / ``topk`` and the like, and
  kernel nodes touch HBM; elementwise, view and convert ops are free (the
  totals are MINIMAL algorithmic traffic, like the closed forms they are
  held to). A product operand widened by a convert is read at its narrow
  origin (an int8 weight widened into the product streams 1 byte an
  element). A gather charges the rows it touched (its output), an
  in-place update the update. Unlike an XLA program, returning an input
  copies nothing, so there is no boundary term.

* **Collective bytes** — the run's ``collectives.CommTrace`` wire bytes,
  keyed like the census (``"psum[data]"``).

* **Peak live bytes** — from the allocation and free order the census
  saw (a finalizer on each storage). Program inputs are live for the whole
  program; a donated input dies at its last use, a donated input that is
  never used never dies. Only storages on the program's device count.

Import discipline: torch and the walker only.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Callable

from distributed_tensorflow_guide_tpu_torch.analysis import walker

# ---- the cost vector -------------------------------------------------------------


@dataclasses.dataclass
class CostVector:
    """One program's derived costs. ``collective_bytes`` is keyed exactly
    like the collective census (``"psum[data]"``)."""

    flops: float = 0.0
    hbm_bytes_read: float = 0.0
    hbm_bytes_written: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=dict)
    peak_live_bytes: int = 0

    @property
    def hbm_bytes(self) -> float:
        return self.hbm_bytes_read + self.hbm_bytes_written

    @property
    def collective_bytes_total(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def quantity(self, name: str) -> float:
        """Resolve a CostPin quantity string: a scalar field name or one
        census-keyed entry spelled ``"collective_bytes[psum[data]]"``
        (0.0 for a key that never ran)."""
        if name.startswith("collective_bytes[") and name.endswith("]"):
            return float(self.collective_bytes.get(name[17:-1], 0.0))
        if not hasattr(self, name) and name not in (
                "hbm_bytes", "collective_bytes_total"):
            raise KeyError(f"unknown cost quantity {name!r}")
        return float(getattr(self, name))

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes_read": self.hbm_bytes_read,
            "hbm_bytes_written": self.hbm_bytes_written,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(sorted(self.collective_bytes.items())),
            "peak_live_bytes": self.peak_live_bytes,
        }


# ---- the kernel cost registry ---------------------------------------------------

#: kernel node name -> model: ``model(node) -> {"flops", "read", "write"}``.
#: Kernels register next to their implementation (ops/decode_attention.py
#: K5/K6, ops/flash_attention.py K1-K4).
_KERNEL_COST_MODELS: dict[str, Callable[[Any], dict]] = {}


def register_kernel_cost(name: str, model: Callable[[Any], dict]) -> None:
    """Register (idempotently) the cost model of one kernel node."""
    _KERNEL_COST_MODELS[name] = model


def operands_once(node) -> dict:
    """The fallback byte rule: operands read once, outputs written once."""
    return {"read": float(sum(m.nbytes for m in node.inputs)),
            "write": float(sum(m.nbytes for m in node.outputs))}


def _kernel_cost(node) -> dict:
    model = _KERNEL_COST_MODELS.get(node.name)
    if model is not None:
        return model(node)
    return {"flops": 0.0, **operands_once(node)}


# ---- products ------------------------------------------------------------------

PRODUCTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution",
                      "_int_mm", "_scaled_mm"})


def product_operands(node) -> list:
    """The two factors of a product node (its bias / scales excluded)."""
    ins = node.inputs
    if node.name in ("addmm", "baddbmm"):
        return ins[1:3]
    return ins[:2]


def product_flops(node) -> float:
    a, b = (m.shape for m in product_operands(node))
    if node.name == "convolution":
        out = node.outputs[0].shape
        # weight (C_out, C_in / groups, k...), out (N, C_out, spatial...)
        return (2.0 * out[0] * math.prod(out[2:]) * out[1] * b[1]
                * math.prod(b[2:]))
    if node.name in ("bmm", "baddbmm"):
        return 2.0 * a[0] * a[1] * a[2] * b[2]
    return 2.0 * a[0] * a[1] * b[1]


# ---- the HBM fusion-boundary classification ------------------------------------

_TOUCHED_ROWS = frozenset({"index", "index_select", "gather", "embedding",
                           "take", "take_along_dim"})
_INPLACE_UPDATES = frozenset({"index_put_", "index_put", "index_copy_",
                              "index_copy", "scatter_", "scatter",
                              "scatter_add_", "scatter_add",
                              "scatter_reduce_", "scatter_reduce",
                              "index_add_", "index_add"})
_REORDER = frozenset({"sort", "topk", "argmax", "argmin", "cumsum",
                      "cumprod", "cummax", "cummin", "logcumsumexp"})


def narrow_bytes(census, m) -> int:
    """``m``'s bytes at the narrowest dtype its storage had on a widening
    convert chain."""
    origin = census.origin.get(m.sid)
    return m.numel * (origin.itemsize if origin is not None
                      else m.dtype.itemsize)


def node_hbm(census, node) -> tuple[float, float]:
    """(read, write) bytes one node moves; (0, 0) for a fused-class op."""
    out_b = float(sum(m.nbytes for m in node.outputs))
    if node.kind == "kernel":
        c = _kernel_cost(node)
        return float(c.get("read", 0.0)), float(c.get("write", 0.0))
    if node.name in PRODUCTS:
        return float(sum(narrow_bytes(census, m)
                         for m in node.inputs)), out_b
    if node.name in _REORDER:
        return float(sum(m.nbytes for m in node.inputs)), out_b
    if node.name in _TOUCHED_ROWS:
        return out_b, out_b
    if node.name in _INPLACE_UPDATES:
        upd = float(sum(m.nbytes for m in node.inputs[1:]))
        return upd, upd
    return 0.0, 0.0


def node_flops(node) -> float:
    if node.kind == "kernel":
        return float(_kernel_cost(node).get("flops", 0.0))
    if node.name in PRODUCTS:
        return product_flops(node)
    return 0.0


# ---- peak live bytes -------------------------------------------------------------


def peak_live_bytes(census, *, donated_sids=frozenset()) -> int:
    """Peak of the live bytes over the run: inputs whole-program (donated
    ones until their last use), every storage an op allocated from that
    op to the point its finalizer ran (or the end)."""
    dev = census.device.type if census.device is not None else None
    n = len(census.nodes)
    delta = [0.0] * (n + 2)
    base = 0.0
    last = census.last_use()
    for s in census.storages.values():
        if dev is not None and s.device != dev:
            continue
        if s.alloc == -1:
            if s.sid in donated_sids and s.sid in last:
                base += s.nbytes
                delta[last[s.sid] + 1] -= s.nbytes
            else:
                base += s.nbytes
        elif s.alloc is not None:
            delta[s.alloc] += s.nbytes
            end = n if s.free is None else s.free
            delta[max(end, s.alloc + 1)] -= s.nbytes
    live = peak = base
    for i in range(n):
        live += delta[i]
        peak = max(peak, live)
    return int(peak)


# ---- the port's closed forms ---------------------------------------------------


def fused_ce_trace_terms(n_rows: int, d_model: int, vocab: int, chunk: int,
                         *, act_bytes: int = 2, param_bytes: int = 2,
                         accum_bytes: int = 4, index_bytes: int = 8) -> dict:
    """Fusion-boundary traffic of the port's fused-CE loss and gradient
    (``ops/fused_ce.py``): per vocab chunk, the forward logit product, the
    target-logit gather (``z[rows, t]``, the touched rows read and
    written), the backward's recomputed product, the ``- onehot``
    scatter-add into it (one int64 index and one f32 value a row, read
    and written as an in-place update), and the dx and dW products. The
    JAX package's model has the same terms but the scatter (its one-hot
    subtraction is elementwise)."""
    n_chunks = -(-vocab // chunk)
    x = n_rows * d_model * act_bytes
    w_c = d_model * chunk * param_bytes
    dz_c = n_rows * chunk * act_bytes
    score_c = n_rows * chunk * accum_bytes
    return {
        "fwd_dot_read": float(n_chunks * (x + w_c)),
        "fwd_dot_write": float(n_chunks * score_c),
        "target_gather": float(n_chunks * 2 * n_rows * accum_bytes),
        "bwd_recompute_read": float(n_chunks * (x + w_c)),
        "bwd_recompute_write": float(n_chunks * score_c),
        "onehot_scatter": float(n_chunks * 2 * n_rows
                                * (index_bytes + accum_bytes)),
        "dx_dot_read": float(n_chunks * (dz_c + w_c)),
        "dx_dot_write": float(n_chunks * n_rows * d_model * accum_bytes),
        "dw_dot_read": float(n_chunks * (x + dz_c)),
        "dw_dot_write": float(n_chunks * d_model * chunk * accum_bytes),
    }


def fused_ce_trace_bytes(n_rows: int, d_model: int, vocab: int, chunk: int,
                         **kw) -> float:
    """Sum of :func:`fused_ce_trace_terms`: the ``hbm_bytes`` pin of the
    ``fused_ce_loss_grad`` contract."""
    return sum(fused_ce_trace_terms(n_rows, d_model, vocab, chunk,
                                    **kw).values())


def closed_forms() -> SimpleNamespace:
    """The closed-form models the CostSpec pins are held to: the port's
    own copies (the JAX package keeps its in ``benchmarks/common.py``)."""
    from distributed_tensorflow_guide_tpu_torch.ops import decode_attention

    return SimpleNamespace(
        fused_ce_trace_terms=fused_ce_trace_terms,
        fused_ce_trace_bytes=fused_ce_trace_bytes,
        decode_kernel_hbm_bytes=decode_attention.decode_kernel_hbm_bytes)


# ---- public entry ------------------------------------------------------------------


def donated_sids(contract, census) -> frozenset[int]:
    """The storages of the contract's donated arguments."""
    spec = getattr(contract, "donation", None)
    if spec is None:
        return frozenset()
    return frozenset(s for a in spec.argnums if a < len(census.arg_sids)
                     for s in census.arg_sids[a])


def census_cost(census, *, donated=frozenset()) -> CostVector:
    """The cost vector of one census."""
    vec = CostVector()
    for node in census.nodes:
        vec.flops += node_flops(node)
        r, w = node_hbm(census, node)
        vec.hbm_bytes_read += r
        vec.hbm_bytes_written += w
    for key, wire in (census.comm.wire.items() if census.comm else ()):
        k = walker.census_key(key)
        vec.collective_bytes[k] = vec.collective_bytes.get(k, 0.0) + wire
    vec.peak_live_bytes = peak_live_bytes(census, donated_sids=donated)
    return vec


def program_cost(traced, contract) -> CostVector:
    """The full cost vector of one traced contract program."""
    return census_cost(traced.census,
                       donated=donated_sids(contract, traced.census))
