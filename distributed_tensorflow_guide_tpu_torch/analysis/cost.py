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
  keyed like the census (``"psum[data]"``), under the ring model: an
  all-reduce puts 2·P·(n−1)/n on the wire, a reduce-scatter and an
  all-to-all P·(n−1)/n, an all-gather of a P-byte shard P·(n−1), and a
  ``ppermute`` P per destination, so a rank that only receives records 0.
  Two conventions read these bytes. A rank's census holds its own wire
  bytes (one process, one rank). A mesh program (``ProgramContract.
  world``) is held to the WORLD MEAN of each key, the sum over its ranks
  / N: the JAX package's per-device convention, whose SPMD census prices
  a ``ppermute`` at bytes × hops / n_devices. Where every rank sends
  alike (an all-reduce) the two agree; a point-to-point transfer from
  one slice to the other reads P on a sender, 0 on a receiver and P/2 as
  the mean over two slices.

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


def dp_allreduce_bytes(grad_bytes: float, world: int,
                       compress: str | None = None) -> float:
    """Sync-DP gradient all-reduce per rank: a ring reduce-scatter and
    all-gather, each moving (n−1)/n of the buffer, 2·P·(n−1)/n; 0 on an
    axis of one rank. ``grad_bytes`` is the f32 gradient size;
    ``compress="int8"`` prices the int8 wire, 1 byte an element (P/4);
    callers add ``n_buckets * dp_allreduce_bytes(4, world)`` for the
    shared-scale ``pmax``."""
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', got "
                         f"{compress!r}")
    if world <= 1:
        return 0.0
    wire = grad_bytes / 4.0 if compress == "int8" else float(grad_bytes)
    return 2.0 * wire * (world - 1) / world


def pipeline_ppermute_bytes(act_bytes: float, num_microbatches: int,
                            stages: int) -> float:
    """Pipeline traffic per rank a step: each microbatch's activation
    crosses every stage boundary once forward and its cotangent once
    backward, 2·M·act·(P−1)/P averaged over the ring; 0 at P = 1. It has
    no virtual-chunk factor: at v = 1 it is ``PipelinedLM.
    pipe_wire_bytes_per_step / P``, which counts P·v − 1 boundaries."""
    if stages <= 1:
        return 0.0
    return 2.0 * num_microbatches * act_bytes * (stages - 1) / stages


def moe_all_to_all_bytes(dispatch_buffer_bytes: float, expert_world: int,
                         n_layers: int = 1, passes: int = 4) -> float:
    """Expert-parallel routing traffic per rank a step: each MoE layer
    crosses the expert axis ``passes`` times (training: dispatch and
    return forward, their transposes backward; serving: 2), each an
    all-to-all keeping the local 1/e share, passes·L·B·(e−1)/e with B the
    dispatch buffer (E · capacity · d_model · itemsize)."""
    if expert_world <= 1:
        return 0.0
    return (float(passes) * n_layers * dispatch_buffer_bytes
            * (expert_world - 1) / expert_world)


def outer_sync_bytes(float_state_bytes: float, n_slices: int,
                     compress: str | None = None) -> float:
    """The two-tier outer sync per rank a round (``parallel/
    multislice.py``): a ring all-reduce across slices of the float
    parameter delta and the float inner-optimizer state, 2·P·(n−1)/n
    with n the slice count; 0 at one slice."""
    return dp_allreduce_bytes(float_state_bytes, n_slices, compress)


def kv_migration_bytes_terms(n_blocks: int, num_layers: int,
                             num_heads: int, block_size: int,
                             head_dim: int, kv_dtype: str | None = None, *,
                             activation_dtype_bytes: int = 2) -> dict:
    """Payload bytes of migrating ``n_blocks`` written KV blocks, split
    into terms: per layer a K and a V row ``(H, block_size, hd)`` at the
    activation dtype, or int8 with the two f32 scale rows ``(H, 1,
    block_size)`` the int8 pool holds a block (one scale a position and
    head). For any config of this geometry the total is ``serve/
    paged_cache.kv_migration_bytes(n_blocks, cfg, block_size)``, which
    reads the same numbers off the config. The JAX package's form counts
    the int8 scales per head dim instead, so the two agree on int8 only
    where the block size equals the head dim."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    elems = 2 * num_layers * num_heads * block_size * head_dim
    if kv_dtype is None:
        return {"kv_payload_bytes":
                float(n_blocks * activation_dtype_bytes * elems)}
    return {"kv_payload_bytes": float(n_blocks * elems),
            "kv_scale_bytes":
                float(n_blocks * 4 * 2 * num_layers * num_heads
                      * block_size)}


def kv_migration_bytes(n_blocks: int, num_layers: int, num_heads: int,
                       block_size: int, head_dim: int,
                       kv_dtype: str | None = None, *,
                       activation_dtype_bytes: int = 2) -> float:
    """Sum of :func:`kv_migration_bytes_terms`."""
    return sum(kv_migration_bytes_terms(
        n_blocks, num_layers, num_heads, block_size, head_dim, kv_dtype,
        activation_dtype_bytes=activation_dtype_bytes).values())


def closed_forms() -> SimpleNamespace:
    """The closed-form models the CostSpec pins are held to: the port's
    own copies (the JAX package keeps its in ``benchmarks/common.py``);
    ZeRO-3's split is ``parallel/fsdp.fsdp_comm_terms``."""
    from distributed_tensorflow_guide_tpu_torch.ops import decode_attention
    from distributed_tensorflow_guide_tpu_torch.parallel import fsdp

    return SimpleNamespace(
        fused_ce_trace_terms=fused_ce_trace_terms,
        fused_ce_trace_bytes=fused_ce_trace_bytes,
        decode_kernel_hbm_bytes=decode_attention.decode_kernel_hbm_bytes,
        dp_allreduce_bytes=dp_allreduce_bytes,
        fsdp_comm_terms=fsdp.fsdp_comm_terms,
        pipeline_ppermute_bytes=pipeline_ppermute_bytes,
        moe_all_to_all_bytes=moe_all_to_all_bytes,
        outer_sync_bytes=outer_sync_bytes,
        kv_migration_bytes_terms=kv_migration_bytes_terms,
        kv_migration_bytes=kv_migration_bytes)


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


def world_mean(vectors: list[CostVector]) -> CostVector:
    """The per-device view of a world's cost vectors: every field the mean
    over the ranks (a collective key absent on a rank counts 0 there),
    peak live bytes the largest rank's."""
    n = len(vectors)
    keys = sorted({k for v in vectors for k in v.collective_bytes})
    return CostVector(
        flops=sum(v.flops for v in vectors) / n,
        hbm_bytes_read=sum(v.hbm_bytes_read for v in vectors) / n,
        hbm_bytes_written=sum(v.hbm_bytes_written for v in vectors) / n,
        collective_bytes={k: sum(v.collective_bytes.get(k, 0.0)
                                 for v in vectors) / n for k in keys},
        peak_live_bytes=max(v.peak_live_bytes for v in vectors))


def program_cost(traced, contract) -> CostVector:
    """The full cost vector of one traced contract program."""
    return census_cost(traced.census,
                       donated=donated_sids(contract, traced.census))
