"""Pipeline parallelism: judged config 5, "GPT-2 124M pipeline-parallel".

The JAX package writes each schedule as one SPMD program: the stages are
shards of a stacked-layer tree over the ``pipe`` axis, a ``lax.scan``
runs the ticks, and every tick ``ppermute``s around the whole ring (zeros
on idle ticks) so that every device joins each collective. Here a stage
is a process, and each rank runs its own share of a static schedule table
in plain Python:

* the tables are the JAX package's (own copies below: GPipe's
  :func:`_make_interleaved_schedule`, which is plain GPipe at v = 1,
  :func:`_make_1f1b_schedule` and :func:`_make_interleaved_1f1b_schedule`);
* on each tick a rank runs at most one forward or backward of one of its
  layer chunks, then the ranks hand off what the tick produced: one
  ``ppermute`` over ``pipe`` for the activations, one for the cotangents,
  each a partial permutation that holds only the live hand-offs. A rank
  that neither sends nor receives on a tick makes no call, and nothing is
  sent on an idle tick. Each microbatch's activation crosses the P·v − 1
  chunk boundaries once forward and its cotangent once backward, so a
  pipe group puts exactly 2 · M · act · (P·v − 1) bytes on the wire a step
  (:meth:`PipelinedLM.pipe_wire_bytes_per_step`);
* GPipe keeps every microbatch's autograd graph from the forward ticks and
  runs the backward as explicit hand-offs in reverse tick order (the
  reversed forward table is a valid backward schedule); 1F1B saves only
  each chunk's input on a forward tick (run without a graph; the last
  chunk-stage, which hands nothing on, runs nothing there) and, on its
  backward tick, runs the chunk from it and calls
  ``torch.autograd.backward`` with the cotangent received (the loss, on
  the last chunk-stage), so about P stage inputs are live, not M graphs.

Layout: a rank holds the layer rows of its stage (chunk-stage
k = j·P + s lives on stage s as local chunk j; at v = 1 stage s holds
layers [s·L/P, (s+1)·L/P)), and a copy of the embedding and of the head
(LayerNorm and an f32 ``lm_head`` without bias). Only stage 0 embeds and
only stage P − 1 runs the head; their gradients are summed over ``pipe``,
so the copies stay equal. With a ``model`` axis > 1 the layers are
Megatron-sharded (``cfg.tp_local``), the embedding is looked up
vocab-parallel and the loss is taken vocab-parallel (3D: dp x tp x pp);
gradients and the loss are averaged over ``data``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_guide_tpu_torch.collectives import (
    collectives as cc,
)
from distributed_tensorflow_guide_tpu_torch.core import (
    precision as precision_mod,
)
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.graphs import MultiStep
from distributed_tensorflow_guide_tpu_torch.core.mesh import Mesh, axis_sizes
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Block,
    LayerNorm,
    Transformer,
    TransformerConfig,
    _linear,
    vocab_parallel_embed,
    vocab_parallel_next_token_loss,
)
from distributed_tensorflow_guide_tpu_torch.ops.fused_ce import (
    fused_next_token_loss,
    resolve_fused_ce,
)
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    capturable,
    to_device,
)
from distributed_tensorflow_guide_tpu_torch.parallel.tensor import (
    gather_state_dict,
    local_config,
    shard_tensor,
)

log = logging.getLogger("dtg.parallel.pipeline")


# ---- the static schedule tables (the JAX package's, copied) -----------------


def _freeze_tables(fn):
    """Cache a schedule generator on its (M, P, v) key and mark the numpy
    tables read-only, so that a caller cannot change a shared table."""

    @functools.lru_cache(maxsize=64)
    def cached(*key):
        out = fn(*key)
        for v_ in out.values():
            if hasattr(v_, "flags"):
                v_.flags.writeable = False
        return out

    return functools.wraps(fn)(cached)


@_freeze_tables
def _make_1f1b_schedule(M: int, P: int):
    """Static 1F1B schedule (Narayanan et al. 2019, PipeDream-flush).

    Tables: ``op[t, s]`` in {0 idle, 1 forward, 2 backward}, ``mb[t, s]``
    its microbatch; ``sa``/``sam`` (an activation sent by s-1 at t-1 lands
    on s at t, for microbatch ``sam``) and ``sc``/``scm`` (a cotangent from
    s+1); ring depth ``R`` (the most microbatches in flight, checked so
    that no slot is overwritten before it is consumed); ``T`` ticks.

    Greedy simulation: each stage forwards through its warm-up window
    (min(P-s, M) microbatches), then alternates backward-preferred and
    forward, which caps a stage's microbatches in flight at ~P-s instead
    of GPipe's M.
    """
    next_f = [0] * P
    next_b = [0] * P
    f_tick = [[-1] * M for _ in range(P)]
    b_tick = [[-1] * M for _ in range(P)]
    op_rows: list[list[int]] = []
    mb_rows: list[list[int]] = []
    t = 0
    max_inflight = 1
    while any(next_b[s] < M for s in range(P)):
        row_op = [0] * P
        row_mb = [0] * P
        for s in range(P):
            cap = min(P - s, M)  # 1F1B in-flight bound for stage s
            can_f = (
                next_f[s] < M
                and next_f[s] - next_b[s] < cap
                and (s == 0 or 0 <= f_tick[s - 1][next_f[s]] < t)
            )
            can_b = next_b[s] < next_f[s] and (
                s == P - 1 or 0 <= b_tick[s + 1][next_b[s]] < t
            )
            if s == P - 1 and can_b and not (0 <= f_tick[s][next_b[s]] < t):
                can_b = False
            in_warmup = next_f[s] < cap
            if can_f and in_warmup:
                row_op[s], row_mb[s] = 1, next_f[s]
            elif can_b:
                row_op[s], row_mb[s] = 2, next_b[s]
            elif can_f:
                row_op[s], row_mb[s] = 1, next_f[s]
        for s in range(P):
            if row_op[s] == 1:
                f_tick[s][row_mb[s]] = t
                next_f[s] += 1
            elif row_op[s] == 2:
                b_tick[s][row_mb[s]] = t
                next_b[s] += 1
            max_inflight = max(max_inflight, next_f[s] - next_b[s])
        op_rows.append(row_op)
        mb_rows.append(row_mb)
        t += 1
        if t > 6 * (M + P) + 16:
            raise RuntimeError("1F1B schedule generation did not converge")
    T = t
    op = np.array(op_rows, np.int32)
    mb = np.array(mb_rows, np.int32)

    # receive bookkeeping: arrival at tick t is what the neighbor sent at t-1
    sa = np.zeros((T, P), np.int32)
    sam = np.zeros((T, P), np.int32)
    sc = np.zeros((T, P), np.int32)
    scm = np.zeros((T, P), np.int32)
    for tt in range(1, T):
        for s in range(P):
            if s > 0 and op[tt - 1, s - 1] == 1:
                sa[tt, s], sam[tt, s] = 1, mb[tt - 1, s - 1]
            if s < P - 1 and op[tt - 1, s + 1] == 2:
                sc[tt, s], scm[tt, s] = 1, mb[tt - 1, s + 1]

    def slots_ok(R: int) -> bool:
        """No buffer slot may be overwritten before its consumer runs."""
        for s in range(P):
            intervals: dict[int, list[tuple[int, int]]] = {}

            def add(slot, t0, t1):
                intervals.setdefault(slot, []).append((t0, t1))

            for m in range(M):
                if s > 0:
                    add(m % R, f_tick[s - 1][m] + 1, f_tick[s][m])
                add((m % R) + R, f_tick[s][m], b_tick[s][m])  # resid
                if s < P - 1:
                    add((m % R) + 2 * R, b_tick[s + 1][m] + 1, b_tick[s][m])
            for spans in intervals.values():
                spans.sort()
                for (a0, a1), (b0, _b1) in zip(spans, spans[1:]):
                    if b0 <= a1:
                        return False
        return True

    R = max_inflight
    while not slots_ok(R):  # pragma: no cover - safety margin
        R += 1
    return {"op": op, "mb": mb, "sa": sa, "sam": sam, "sc": sc, "scm": scm,
            "R": R, "T": T}


@_freeze_tables
def _make_interleaved_1f1b_schedule(M: int, P: int, v: int):
    """Static interleaved-1F1B schedule (Megatron-LM's combined schedule,
    Narayanan et al. 2021 §2.2): 1F1B's O(P) in-flight cap and
    interleaving's ~v-fold smaller bubble in one table.

    D = v·P chunk-stages; chunk-stage k = j·P + s runs on device s as local
    chunk row j. Each device runs a fixed op sequence (warm-up forwards,
    then 1F/1B pairs, then cool-down backwards) and stalls while an op's
    input has not arrived. Needs ``M % P == 0``: forwards are
    chunk-grouped (chunk 0 takes microbatches 0..P-1, then chunk 1 the
    same, ...), backwards mirror them with the chunks reversed; warm-up
    length W(s) = min(v·M, 2·(P-s-1) + (v-1)·P).

    Tables (T, P): ``op`` (0 idle / 1 fwd / 2 bwd), ``jr`` (local chunk
    row), ``mb``; arrivals ``sa``/``saj``/``sam`` and ``sc``/``scj``/``scm``;
    ring depth ``R``; ``f_done``/``b_done`` tick stamps; ``max_inflight``;
    ``T``.
    """
    if P < 2 or v < 2:
        raise ValueError(f"interleaved 1F1B needs P >= 2, v >= 2 (got {P}, {v})")
    if M % P:
        raise ValueError(
            f"interleaved 1F1B requires num_microbatches % pipe == 0 "
            f"(got M={M}, P={P}) — the chunk-grouped issue order rides "
            "groups of P microbatches"
        )
    D = v * P
    TF = v * M  # forward (and backward) ops per device

    def f_index(i):
        group, pos = divmod(i, P)
        rnd, j = divmod(group, v)
        return j, rnd * P + pos

    def b_index(i):
        group, pos = divmod(i, P)
        rnd, jr = divmod(group, v)
        return v - 1 - jr, rnd * P + pos

    seqs: list[list[tuple[int, int, int]]] = []
    for s in range(P):
        W = min(TF, 2 * (P - s - 1) + (v - 1) * P)
        ops: list[tuple[int, int, int]] = []
        nf = nb = 0
        while nf < W:
            ops.append((1, *f_index(nf)))
            nf += 1
        while nf < TF:
            ops.append((1, *f_index(nf)))
            nf += 1
            ops.append((2, *b_index(nb)))
            nb += 1
        while nb < TF:
            ops.append((2, *b_index(nb)))
            nb += 1
        seqs.append(ops)

    ptr = [0] * P
    f_done = [[-1] * M for _ in range(D)]
    b_done = [[-1] * M for _ in range(D)]
    rows: list[list[tuple[int, int, int]]] = []
    t = 0
    while any(ptr[s] < 2 * TF for s in range(P)):
        row: list[tuple[int, int, int]] = []
        for s in range(P):
            if ptr[s] >= 2 * TF:
                row.append((0, 0, 0))
                continue
            op, j, m = seqs[s][ptr[s]]
            k = j * P + s
            if op == 1:
                ready = k == 0 or 0 <= f_done[k - 1][m] < t
            else:
                ready = 0 <= f_done[k][m] < t and (
                    k == D - 1 or 0 <= b_done[k + 1][m] < t
                )
            row.append((op, j, m) if ready else (0, 0, 0))
        progress = False
        for s, (op, j, m) in enumerate(row):
            if op == 1:
                f_done[j * P + s][m] = t
                ptr[s] += 1
                progress = True
            elif op == 2:
                b_done[j * P + s][m] = t
                ptr[s] += 1
                progress = True
        if not progress:  # pragma: no cover - the fixed order is deadlock-free
            raise RuntimeError(
                f"interleaved 1F1B schedule deadlocked at tick {t} "
                f"(M={M}, P={P}, v={v})"
            )
        rows.append(row)
        t += 1
        if t > 8 * (TF + P) + 16:  # pragma: no cover - safety
            raise RuntimeError("interleaved 1F1B schedule did not converge")
    T = t

    op = np.zeros((T, P), np.int32)
    jr = np.zeros((T, P), np.int32)
    mb = np.zeros((T, P), np.int32)
    for tt, row in enumerate(rows):
        for s, (o, j, m) in enumerate(row):
            op[tt, s], jr[tt, s], mb[tt, s] = o, j, m

    # arrivals: what device s-1 forwarded at t-1 lands on s at t (for
    # chunk-stage k+1, unless k was the tap D-1); what device s+1
    # backwarded at t-1 lands on s as the cotangent of chunk-stage k-1
    sa = np.zeros((T, P), np.int32)
    saj = np.zeros((T, P), np.int32)
    sam = np.zeros((T, P), np.int32)
    sc = np.zeros((T, P), np.int32)
    scj = np.zeros((T, P), np.int32)
    scm = np.zeros((T, P), np.int32)
    for tt in range(1, T):
        for s in range(P):
            o, j, m = rows[tt - 1][(s - 1) % P]
            if o == 1:
                k = j * P + (s - 1) % P
                if k + 1 < D:
                    assert (k + 1) % P == s
                    sa[tt, s], saj[tt, s], sam[tt, s] = 1, (k + 1) // P, m
            o, j, m = rows[tt - 1][(s + 1) % P]
            if o == 2:
                k = j * P + (s + 1) % P
                if k - 1 >= 0:
                    assert (k - 1) % P == s
                    sc[tt, s], scj[tt, s], scm[tt, s] = 1, (k - 1) // P, m

    def slots_ok(R: int) -> bool:
        """No (j*M+m) % R slot overwritten before its consumer runs."""
        for s in range(P):
            intervals: dict[int, list[tuple[int, int]]] = {}

            def add(slot, t0, t1):
                intervals.setdefault(slot, []).append((t0, t1))

            for j in range(v):
                k = j * P + s
                for m in range(M):
                    u = (j * M + m) % R
                    if k > 0:
                        add(u, f_done[k - 1][m] + 1, f_done[k][m])
                    add(u + R, f_done[k][m], b_done[k][m])  # resid
                    if k < D - 1:
                        add(u + 2 * R, b_done[k + 1][m] + 1, b_done[k][m])
            for spans in intervals.values():
                spans.sort()
                for (a0, a1), (b0, _b1) in zip(spans, spans[1:]):
                    if b0 <= a1:
                        return False
        return True

    max_inflight = 1
    for s in range(P):
        events = []
        for j in range(v):
            k = j * P + s
            for m in range(M):
                events.append((f_done[k][m], 1))
                events.append((b_done[k][m], -1))
        cur = 0
        for _, d in sorted(events):
            cur += d
            max_inflight = max(max_inflight, cur)
    R = max_inflight
    while not slots_ok(R):
        R += 1
    return {"op": op, "jr": jr, "mb": mb, "sa": sa, "saj": saj, "sam": sam,
            "sc": sc, "scj": scj, "scm": scm, "R": R, "T": T,
            "f_done": f_done, "b_done": b_done,
            "max_inflight": max_inflight}


@_freeze_tables
def _make_interleaved_schedule(M: int, P: int, v: int):
    """Forward schedule of (interleaved) GPipe: D = v·P chunk-stages laid
    round-robin on P devices (chunk-stage k lives on device k % P as local
    chunk row j = k // P), one op per device per tick, deepest ready chunk
    first; chunk-stage k of microbatch m runs strictly after k-1 of m. At
    v = 1 it is plain GPipe: stage s runs microbatch t - s on tick t.

    Tables (T, P): ``jrow``/``mbrow`` (the op, -1 = idle),
    ``rflag``/``rj``/``rm`` (landing slot of the activation that arrives
    this tick), ``done[k][m]`` tick stamps, ``T``.
    """
    D = v * P
    done = [[-1] * M for _ in range(D)]
    nxt = [0] * D
    t = 0
    ops: list[list[tuple[int, int]]] = []
    while any(nxt[k] < M for k in range(D)):
        row = [(-1, -1)] * P
        for s in range(P):
            for j in reversed(range(v)):
                k = j * P + s
                m = nxt[k]
                if m >= M:
                    continue
                if k == 0 or 0 <= done[k - 1][m] < t:
                    row[s] = (j, m)
                    break
        for s in range(P):
            j, m = row[s]
            if j >= 0:
                done[j * P + s][m] = t
                nxt[j * P + s] += 1
        ops.append(row)
        t += 1
        if t > 10 * (M * v + P) + 16:  # pragma: no cover - safety
            raise RuntimeError("interleaved schedule did not converge")
    T = t
    jrow = np.full((T, P), -1, np.int32)
    mbrow = np.zeros((T, P), np.int32)
    for tt, row in enumerate(ops):
        for s in range(P):
            j, m = row[s]
            jrow[tt, s] = j
            mbrow[tt, s] = m if j >= 0 else 0
    # arrivals: what device s-1 (mod P) ran at t-1 lands on s at t, for
    # chunk-stage k+1 (same local row j, or j+1 when wrapping P-1 -> 0);
    # the last chunk-stage's output is the tap, not a hand-off
    rflag = np.zeros((T, P), np.int32)
    rj = np.zeros((T, P), np.int32)
    rm = np.zeros((T, P), np.int32)
    for tt in range(1, T):
        for s in range(P):
            sp = (s - 1) % P
            j, m = ops[tt - 1][sp]
            if j < 0:
                continue
            k_next = j * P + sp + 1
            if k_next >= D:
                continue
            assert k_next % P == s
            rflag[tt, s] = 1
            rj[tt, s] = k_next // P
            rm[tt, s] = m
    return {"jrow": jrow, "mbrow": mbrow, "rflag": rflag, "rj": rj,
            "rm": rm, "done": done, "T": T}


def _gpipe_ops(M: int, P: int, v: int) -> list[list[tuple[int, int, int]]]:
    """(op, j, m) per tick and device of (interleaved) GPipe's forward
    table: op 1 where a chunk runs, 0 on an idle tick."""
    s = _make_interleaved_schedule(M, P, v)
    return [[(1, int(j), int(m)) if j >= 0 else (0, 0, 0)
             for j, m in zip(jr, mr)]
            for jr, mr in zip(s["jrow"], s["mbrow"])]


def _1f1b_ops(M: int, P: int, v: int) -> list[list[tuple[int, int, int]]]:
    """(op, j, m) per tick and device of the (interleaved) 1F1B table."""
    if v == 1:
        s = _make_1f1b_schedule(M, P)
        return [[(int(o), 0, int(m)) for o, m in zip(orow, mrow)]
                for orow, mrow in zip(s["op"], s["mb"])]
    s = _make_interleaved_1f1b_schedule(M, P, v)
    return [[(int(o), int(j), int(m)) for o, j, m in zip(orow, jrow, mrow)]
            for orow, jrow, mrow in zip(s["op"], s["jr"], s["mb"])]


# ---- one rank's share of the model ------------------------------------------


class _Embedder(nn.Module):
    def __init__(self, vocab: int, cfg: TransformerConfig):
        super().__init__()
        self.tok_emb = nn.Embedding(vocab, cfg.d_model)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)


class _Head(nn.Module):
    """LayerNorm and the f32 LM head without a bias."""

    def __init__(self, vocab: int, cfg: TransformerConfig):
        super().__init__()
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        self.lm_head = nn.Linear(cfg.d_model, vocab, bias=False)


class PipelineStage(nn.Module):
    """The parameters one rank holds: ``embed`` and ``head`` (copies on
    every stage), and ``chunks[j]``, the ``Lc`` blocks of its local chunk
    row j (chunk-stage j·P + s)."""

    def __init__(self, cfg: TransformerConfig, block_cfg: TransformerConfig,
                 vocab: int, virtual_chunks: int, layers_per_chunk: int):
        super().__init__()
        self.embed = _Embedder(vocab, cfg)
        self.chunks = nn.ModuleList(
            nn.ModuleList(Block(block_cfg) for _ in range(layers_per_chunk))
            for _ in range(virtual_chunks))
        self.head = _Head(vocab, cfg)


_CHUNK_NAME = re.compile(r"chunks\.(\d+)\.(\d+)\.(.*)")


def _global_name(local: str, stage: int, n_stages: int,
                 layers_per_chunk: int) -> str:
    """A :class:`PipelineStage` parameter name -> the ``Transformer``
    name it is (a shard of)."""
    if local.startswith(("embed.", "head.")):
        return local.split(".", 1)[1]
    j, l, rest = _CHUNK_NAME.fullmatch(local).groups()
    layer = (int(j) * n_stages + stage) * layers_per_chunk + int(l)
    return f"blocks.{layer}.{rest}"


class PipelinedLM:
    """GPT-2-class LM training over the ``pipe`` (x ``model`` x ``data``)
    mesh axes.

    ``schedule``: "gpipe", "1f1b" or "auto" (GPipe at pipe = 1, where
    1F1B's recompute is pure overhead, 1F1B otherwise).
    ``virtual_chunks`` v > 1 interleaves (Megatron's virtual stages).
    ``fused_ce`` resolves against the device (``ops/fused_ce.py``);
    ``precision`` is a ``core/precision.py`` policy applied to ``cfg``.
    ``device=None`` is this rank's CUDA card (raises without one);
    ``device="cpu"`` runs the plain versions of the kernels.

    Every rank of the mesh builds the object with the same arguments and
    calls each step together; a rank's batch is the share of its ``data``
    index (B = M · microbatch rows), the same on every ``pipe`` and
    ``model`` rank of its group.
    """

    def __init__(self, mesh: Mesh, cfg: TransformerConfig,
                 num_microbatches: int, schedule: str = "gpipe",
                 virtual_chunks: int = 1, fused_ce="auto",
                 ce_chunk: int | None = None, precision=None, *,
                 device=None):
        if schedule not in ("auto", "gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        if precision is not None:
            cfg = precision_mod.resolve(precision).apply_to_transformer(cfg)
        sizes = axis_sizes(mesh)
        if schedule == "auto":
            schedule = "gpipe" if sizes["pipe"] == 1 else "1f1b"
        elif schedule == "1f1b" and sizes["pipe"] == 1:
            log.warning("schedule='1f1b' on a single-stage mesh (pipe=1): "
                        "its recompute holds no activation memory back "
                        "here; schedule='auto' picks GPipe")
        if virtual_chunks < 1:
            raise ValueError(
                f"virtual_chunks must be >= 1, got {virtual_chunks}")
        if virtual_chunks > 1 and schedule == "1f1b":
            if sizes["pipe"] < 2:
                raise ValueError(
                    "interleaved 1F1B needs pipe >= 2 (got "
                    f"{sizes['pipe']}); gpipe handles the degenerate case")
            if num_microbatches % sizes["pipe"]:
                raise ValueError(
                    f"interleaved 1F1B requires num_microbatches divisible "
                    f"by pipe ({num_microbatches} % {sizes['pipe']} != 0)")
        n_chunk_stages = sizes["pipe"] * virtual_chunks
        if cfg.num_layers % n_chunk_stages:
            raise ValueError(
                f"{cfg.num_layers} layers not divisible by "
                f"{n_chunk_stages} chunk-stages ({sizes['pipe']} stages x "
                f"{virtual_chunks} chunks)")
        self.mesh = mesh
        self.cfg = cfg
        self.schedule = schedule
        self.n_stages = sizes["pipe"]
        self.n_data = sizes["data"]
        self.tp = sizes["model"]
        self.stage = mesh.axis("pipe").index
        self.shard = mesh.axis("model").index
        self.num_microbatches = num_microbatches
        self.virtual_chunks = virtual_chunks
        self.layers_per_chunk = cfg.num_layers // n_chunk_stages
        self.device = resolve_device(device)
        self.fused_ce = resolve_fused_ce(fused_ce, vocab_size=cfg.vocab_size,
                                         platform=self.device.type)
        self.ce_chunk = ce_chunk
        if self.tp > 1:
            self.block_cfg = local_config(cfg, self.tp)
        else:
            self.block_cfg = cfg
        self.vocab_local = self.block_cfg.vocab_size

    # -- parameters -----------------------------------------------------------
    def stage_state_dict(self, full: Mapping[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
        """This rank's share of a full ``Transformer`` state dict (or of
        its gradients): its stage's layers, TP-sharded by its ``model``
        index, and the shards of the embedding and head, keyed as
        :class:`PipelineStage`'s parameters."""
        return {n: shard_tensor(g, full[g], self.tp, self.shard)
                for n, g in self._names().items()}

    def _names(self) -> dict[str, str]:
        with torch.device("meta"):
            names = [n for n, _ in self._module().named_parameters()]
        return {n: _global_name(n, self.stage, self.n_stages,
                                self.layers_per_chunk) for n in names}

    def _module(self) -> PipelineStage:
        return PipelineStage(self.cfg, self.block_cfg, self.vocab_local,
                             self.virtual_chunks, self.layers_per_chunk)

    def load_stage(self, stage_sd: Mapping[str, torch.Tensor]
                   ) -> PipelineStage:
        """This rank's :class:`PipelineStage` on the device, holding
        ``stage_sd`` (keyed as its parameters; ``bridge.
        pipeline_stage_from_flax`` gives one)."""
        with torch.device("meta"):
            module = self._module()
        module.load_state_dict(
            {n: t.detach().clone() for n, t in stage_sd.items()},
            assign=True)
        return module.to(self.device)

    def shard_params(self, full: Mapping[str, torch.Tensor]
                     ) -> PipelineStage:
        """This rank's :class:`PipelineStage` from a full ``Transformer``
        state dict (every rank passes the same one)."""
        return self.load_stage(self.stage_state_dict(full))

    def init_params(self, seed: int = 0) -> PipelineStage:
        """This rank's stage of the model that ``Transformer(cfg)
        .init_weights(seed)`` draws (on the CPU, the same on every
        rank)."""
        full = Transformer(dataclasses.replace(
            self.cfg, num_classes=None)).init_weights(seed)
        return self.shard_params(full.state_dict())

    def init_opt_state(self, tx, module: PipelineStage
                       ) -> torch.optim.Optimizer:
        """The optimizer over this rank's parameters: ``tx`` takes the
        parameters, e.g. ``functools.partial(torch.optim.Adam, lr=1e-3)``."""
        return tx(module.parameters())

    def to_serving_params(self, local: "PipelineStage | Mapping"
                          ) -> dict[str, torch.Tensor]:
        """The full ``Transformer`` state dict (for ``models/generation``
        or ``serve/``) from every rank's share: the TP shards merged over
        ``model``, the stages' layers gathered over ``pipe`` into global
        layer order (the interleaved order undone). ``local`` is this
        rank's module or a dict keyed like its parameters (its gradients,
        for one). Every rank calls it and gets the whole dict."""
        if isinstance(local, nn.Module):
            local = dict(local.named_parameters())
        local = {n: t.detach() for n, t in local.items()}
        names = self._names()
        merged = gather_state_dict(
            {names[n]: t for n, t in local.items()}, self.mesh)
        out = {}
        for n, t in local.items():
            g = names[n]
            if not n.startswith("chunks."):
                out[g] = merged[g]
                continue
            parts = cc.all_gather(merged[g], "pipe", mesh=self.mesh)
            for s, part in enumerate(parts.unbind(0)):
                out[_global_name(n, s, self.n_stages,
                                 self.layers_per_chunk)] = part
        return out

    def layout_metadata(self) -> dict:
        """The layout of a rank's parameters, for a checkpoint to refuse a
        restore into another one (a (P=2, v=2) stage holds the same
        shapes as a (P=4, v=1) one, in another layer order)."""
        return {"format": "pipelined_lm_stages",
                "n_stages": self.n_stages,
                "virtual_chunks": self.virtual_chunks,
                "layers_per_chunk": self.layers_per_chunk,
                "tp": self.tp}

    def _act_bytes(self, microbatch_size: int, seq_len: int) -> int:
        return (microbatch_size * seq_len * self.cfg.d_model
                * torch.empty((), dtype=self.cfg.dtype).element_size())

    def ppermute_bytes_per_step(self, microbatch_size: int,
                                seq_len: int | None = None) -> float:
        """The JAX package's closed form of one step's ``ppermute``
        traffic per device: every microbatch's activation crosses the
        P − 1 stage boundaries forward and its gradient backward, averaged
        over the ring, 2 · M · act · (P − 1) / P; 0 at P = 1. The JAX
        package takes S as ``cfg.max_len`` (the default here); a batch of
        shorter sequences sends ``seq_len``. It leaves out v: see
        :meth:`pipe_wire_bytes_per_step`."""
        if self.n_stages <= 1:
            return 0.0
        return (2.0 * self.num_microbatches
                * self._act_bytes(microbatch_size,
                                  seq_len or self.cfg.max_len)
                * (self.n_stages - 1) / self.n_stages)

    def pipe_wire_bytes_per_step(self, microbatch_size: int,
                                 seq_len: int) -> int:
        """The bytes one pipe group's ranks put on the wire a train step
        on microbatches of (``microbatch_size``, ``seq_len``) tokens,
        summed: each microbatch's activation crosses P·v − 1 chunk
        boundaries forward and its cotangent the same ones backward,
        2 · M · act · (P·v − 1); 0 at P = 1, where every hand-off stays on
        the rank. At v = 1 it is P x :meth:`ppermute_bytes_per_step`."""
        if self.n_stages <= 1:
            return 0
        return (2 * self.num_microbatches
                * self._act_bytes(microbatch_size, seq_len)
                * (self.n_stages * self.virtual_chunks - 1))

    # -- the computation of one chunk-stage -----------------------------------
    def _embed(self, module: PipelineStage, toks):
        """(mb, S) ids -> (mb, S, D) at the activation dtype; the token
        table vocab-parallel over ``model`` when it is sharded."""
        e, dt = module.embed, self.cfg.dtype
        if self.tp > 1:
            x = vocab_parallel_embed(toks, e.tok_emb.weight, "model", dt)
        else:
            x = e.tok_emb(toks).to(dt)
        return x + e.pos_emb.weight[:toks.shape[1]].to(dt)

    def _chunk(self, module: PipelineStage, j: int, x):
        """The blocks of local chunk row ``j``; under ``remat_mode=
        "block"`` each block is checkpointed in the GPipe schedules (1F1B
        recomputes its chunks anyway). ``"attention"`` lives in
        ``Block`` and applies to every schedule."""
        remat = (self.cfg.remat_mode == "block" and self.schedule == "gpipe"
                 and torch.is_grad_enabled())
        for blk in module.chunks[j]:
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        return x

    def _mb_loss(self, module: PipelineStage, x, toks):
        """The head and next-token NLL of one microbatch's final
        activations: fused CE (vocab-parallel over ``model`` at tp > 1),
        else the naive vocab-parallel CE at tp > 1, else full logits."""
        h = module.head
        xh = h.ln_f(x)
        axis = "model" if self.tp > 1 else None
        if self.fused_ce:
            return fused_next_token_loss(xh, h.lm_head.weight.t(), toks,
                                         chunk=self.ce_chunk, axis=axis)
        if axis:
            return vocab_parallel_next_token_loss(xh, h.lm_head.weight,
                                                  toks, axis)
        logits = _linear(xh, h.lm_head.weight, dtype=torch.float32)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        ll = logp.gather(-1, toks[:, 1:].long()[..., None])[..., 0]
        return -ll.mean()

    # -- the hand-offs ----------------------------------------------------------
    def _hop(self, row, send, *, op: int, backward: bool, shape,
             into: dict):
        """One tick's hand-offs in one direction. ``row`` holds every
        stage's (op, j, m) this tick; a stage whose op is ``op`` sends to
        the next chunk-stage (the previous one, ``backward``) where there
        is one. A rank takes part only where it sends or receives; what it
        receives lands in ``into`` under the (local chunk, m) it feeds."""
        P, D, s = self.n_stages, self.n_stages * self.virtual_chunks, \
            self.stage
        step = -1 if backward else 1
        perm, lands = [], None
        for src, (o, j, m) in enumerate(row):
            k = j * P + src
            if o != op or not 0 <= k + step < D:
                continue
            dst = (src + step) % P
            perm.append((src, dst))
            if dst == s:
                lands = ((k + step) // P, m)
        if P == 1:  # the hand-off stays on the rank
            if lands is not None:
                into[lands] = send
            return
        if not any(s in pair for pair in perm):
            return
        if send is None:  # a receiver only: a buffer of the shape
            send = torch.empty(shape, dtype=self.cfg.dtype,
                               device=self.device)
        got = cc.ppermute(send, "pipe", perm, mesh=self.mesh)
        if lands is not None:
            into[lands] = got

    # -- the schedules ------------------------------------------------------------
    def _run_gpipe(self, module: PipelineStage, mbs, *, grad: bool):
        """(Interleaved) GPipe: the forward table with every microbatch's
        graph kept, then (``grad``) the backward as hand-offs in reverse
        tick order. Returns this rank's loss sum / M (nonzero on the last
        stage only)."""
        M, P, v = self.num_microbatches, self.n_stages, self.virtual_chunks
        D, s = P * v, self.stage
        shape = mbs.shape[1:] + (self.cfg.d_model,)
        rows = _gpipe_ops(M, P, v)
        arrived, cots, kept = {}, {}, {}
        loss = torch.zeros((), device=self.device)
        for row in rows:
            op, j, m = row[s]
            send = None
            if op:
                k = j * P + s
                if k == 0:
                    x = self._embed(module, mbs[m])
                else:
                    x = arrived.pop((j, m))
                    if grad:
                        x.requires_grad_()
                out = self._chunk(module, j, x)
                if k == D - 1:
                    out = self._mb_loss(module, out, mbs[m]) / M
                    loss += out.detach()
                else:
                    send = out.detach()
                if grad:
                    kept[(j, m)] = (x, out)
            self._hop(row, send, op=1, backward=False, shape=shape,
                      into=arrived)
        if not grad:
            return loss
        for row in reversed(rows):
            op, j, m = row[s]
            send = None
            if op:
                k = j * P + s
                x, out = kept.pop((j, m))
                torch.autograd.backward(
                    out, None if k == D - 1 else cots.pop((j, m)))
                if k > 0:
                    send = x.grad
            self._hop(row, send, op=1, backward=True, shape=shape,
                      into=cots)
        return loss

    def _run_1f1b(self, module: PipelineStage, mbs):
        """(Interleaved) 1F1B from its static table: a forward tick runs
        its chunk without a graph and keeps only the chunk's input; a
        backward tick recomputes the chunk from it and back-propagates
        the cotangent received (or the loss, on the last chunk-stage).
        The last chunk-stage sends nothing forward, so its forward tick
        only keeps the input and the backward tick runs the chunk once."""
        M, P, v = self.num_microbatches, self.n_stages, self.virtual_chunks
        D, s = P * v, self.stage
        shape = mbs.shape[1:] + (self.cfg.d_model,)
        arrived, cots, saved = {}, {}, {}
        loss = torch.zeros((), device=self.device)
        for row in _1f1b_ops(M, P, v):
            op, j, m = row[s]
            k = j * P + s
            send_act = send_cot = None
            if op == 1:
                x = None if k == 0 else arrived.pop((j, m))
                saved[(j, m)] = x
                if k < D - 1:
                    with torch.no_grad():
                        send_act = self._chunk(
                            module, j, self._embed(module, mbs[m])
                            if k == 0 else x)
            elif op == 2:
                x = saved.pop((j, m))
                if k == 0:
                    x = self._embed(module, mbs[m])
                else:
                    x.requires_grad_()
                out = self._chunk(module, j, x)
                if k == D - 1:
                    out = self._mb_loss(module, out, mbs[m]) / M
                    loss += out.detach()
                    torch.autograd.backward(out)
                else:
                    torch.autograd.backward(out, cots.pop((j, m)))
                if k > 0:
                    send_cot = x.grad
            self._hop(row, send_act, op=1, backward=False, shape=shape,
                      into=arrived)
            self._hop(row, send_cot, op=2, backward=True, shape=shape,
                      into=cots)
        return loss

    def _microbatches(self, batch) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        B, S = tokens.shape
        M = self.num_microbatches
        if B % M:
            raise ValueError(f"a batch of {B} rows is not divisible by "
                             f"num_microbatches={M}")
        return tokens.reshape(M, B // M, S)

    def loss_and_grads(self, module: PipelineStage, batch):
        """One step's loss (summed over ``pipe``, averaged over ``data``)
        and this rank's gradients ({parameter name: tensor}; the
        embedding's and head's summed over ``pipe``, all averaged over
        ``data``), without an update."""
        mbs = self._microbatches(batch)
        module.zero_grad(set_to_none=True)
        with self.mesh:
            if self.schedule == "1f1b":
                loss = self._run_1f1b(module, mbs)
            else:
                loss = self._run_gpipe(module, mbs, grad=True)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in module.named_parameters()}
        module.zero_grad(set_to_none=True)
        # the embedding and head copies: only the owning stage computed
        # with them
        shared = {n: g for n, g in grads.items()
                  if not n.startswith("chunks.")}
        grads.update(cc.psum(shared, "pipe", mesh=self.mesh))
        loss = cc.psum(loss, "pipe", mesh=self.mesh)
        if self.n_data > 1:
            grads = cc.pmean(grads, "data", mesh=self.mesh)
            loss = cc.pmean(loss, "data", mesh=self.mesh)
        return loss, grads

    def make_train_step(self, optimizer: torch.optim.Optimizer, *,
                        steps_per_call: int | None = None,
                        stacked_batch: bool = False):
        """``(module, batch{tokens: (B, S)}) -> (module, {"loss"})``: one
        pipelined forward and backward of this rank's share of the batch
        (B = num_microbatches x microbatch rows), then one ``optimizer``
        step (over ``module``'s parameters, updated in place).

        ``steps_per_call=k`` runs k steps a call over ``stacked_batch``
        tokens (k, B, S) or the same tokens k times, metrics the last
        inner step's (the reference's ``lax.scan`` around the schedule).
        A pipeline step is one call whatever its microbatch count; on the
        card, where no axis runs over gloo (one process, or NCCL), the k
        steps are one CUDA graph (``core/graphs.MultiStep``: ``captured``,
        ``eager``), so the host launches one graph where it launched the
        schedule's thousands of kernels. The optimizer must then keep its
        counter on the card (``Adam(..., capturable=True)``).
        """

        def one(module, batch):
            loss, grads = self.loss_and_grads(module, batch)
            for n, p in module.named_parameters():
                p.grad = grads[n]
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return module, {"loss": loss}

        if steps_per_call is None:
            MultiStep.check_args(steps_per_call, stacked_batch)
            return one
        return MultiStep(
            one, steps_per_call=steps_per_call, stacked_batch=stacked_batch,
            per_step_metrics=False,
            capture=capturable(self.mesh, self.device), device=self.device,
            prepare=lambda b: to_device({"tokens": b["tokens"]},
                                        self.device),
            optimizer_of=lambda module: optimizer)

    def make_eval_step(self):
        """``(module, batch) -> {"loss", "perplexity"}``: the forward-only
        GPipe traversal (the forward loss does not depend on the
        schedule), summed over ``pipe``, averaged over ``data``."""

        def eval_step(module, batch):
            mbs = self._microbatches(batch)
            with torch.no_grad(), self.mesh:
                loss = self._run_gpipe(module, mbs, grad=False)
                loss = cc.psum(loss, "pipe")
                if self.n_data > 1:
                    loss = cc.pmean(loss, "data")
            return {"loss": loss, "perplexity": torch.exp(loss)}

        return eval_step

