"""Continuous-batching serving engine over the paged KV pool.

Two step functions serve every request mix:

* ``decode_step`` — all ``slots`` rows advance one token. Each slot
  feeds its pending token at its own write position (the ``(S,)`` index
  vector), writes its k/v through its block table, and samples the next
  token with the request's position-derived seed. Empty and mid-prefill
  slots ride along with all-trash tables: their writes land in the trash
  block, the mask hides whatever they read, and the host discards their
  samples.
* ``prefill_chunk_step`` — ONE request advances by one
  ``prefill_chunk``-token chunk (B=1, fixed chunk width). Long prompts
  stream through in chunks interleaved with decode steps. The final
  chunk's sample at the prompt's last valid row IS the request's first
  generated token.

Both read the pool through the K6 kernel and write it in place (the
JAX package donates and returns the pool; here the one pool tensor per
layer is simply updated). Sampling seeds derive from (request key,
absolute position), which makes every per-request stream bitwise the
one-shot ``make_generate_fn`` run of that request alone, however the
scheduler interleaved it — through chunked prefill and preemption too.
On the card that holds only where both sides prefill the prompt in the
same regime (one engine chunk against a one-shot chunk of 10 to 64 rows:
``models/generation.py`` says why); elsewhere they agree to rounding.

The keys a split of K6's split regime (``ops/decode_attention.py``) are
resolved once, when the step functions are built and before any graph is
captured (``models/generation.decode_split_config``): the tuning table's
``decode_split`` entry, the one the one-shot generator reads too, or with
``online_tune`` and no entry an in-situ sweep at the engine's own slots
and pool; the captured graphs hold the split count, the keys and the
workspace as constants.

On the card each step function is captured once as a CUDA graph
(``core/graphs.CapturedStep``), the JAX package's two jitted programs:
the host packs a step's inputs (block tables, write positions, tokens,
position keys, adapter ids) into one pinned int64 buffer, one copy puts
them into the graph's static device buffer, and the graph replays;
the pool, the weights and the LoRA banks are captured by address and
never reallocated. ``fns.captures`` stays at one per graph over the
engine's life, and writing new adapter weights into the banks in place
recaptures nothing. A capture or replay that fails raises: nothing falls
back to the eager step on the card. ``fns.decode_fn`` and
``fns.prefill_fn`` are the same steps run eagerly (one host-to-device
copy, then the step's kernels), which the card's bitwise check holds the
graphs to; on the CPU they are the steps.

Multi-LoRA (``cfg.lora_rank``, ``adapters=``): both steps take the
per-slot adapter ids, and the model view's delta banks serve every
adapter resident in the batch — still two graphs, no per-adapter ones.

Mixture of experts (``cfg.moe_experts``): both steps route inside the
graph and return the census with the tokens, packed into one int64
vector, so a tick still reads the device once. Decode keeps idle slots
out of the routing (``written > 0``) and seats ``moe_capacity`` tokens an
expert; prefill keeps its pad rows out and is dropless. A slot whose
token overflowed an expert in some layer stalls (degrade-to-overflow):
its sample is discarded, ``pending`` and ``written`` stay, and the same
token is tried again next tick (its k/v rows are rewritten with the same
values). Seats fill in slot order, so the lowest contending slot always
advances, and every emitted token was computed by its own experts: the
streams stay bitwise the solo one-shot generator's (which, one request
at a time, never overflows). ``health()["moe"]`` holds the per-expert
load and overflow summed over launches and layers and the stall counts.

Serving under fire: the position-derived keys make every recovery path
bitwise-safe.

* A failed launch (an injected ``serve_step_exception`` or a real one) is
  retried through ``retry_with_backoff``: the tick's inputs are rebuilt
  from host state, so the re-run IS the original tick.
* ``step_deadline_s`` arms a watchdog around each launch attempt: a hung
  step becomes a retriable :class:`WatchdogTimeout` instead of a silent
  stall. The interrupt lands between bytecodes, so a host blocked in C
  (a graph replay whose queue is full, the readback's sync) takes it
  when that call returns (``utils/watchdog.py``).
* ``chaos=`` (a ``testing.chaos.FaultSchedule``) applies the serve fault
  kinds at their ticks: launch failures, client abandons, arrival bursts
  (``burst_factory``), pool pressure (blocks held away for a few ticks,
  forcing evictions) and snapshot damage.
* :meth:`ServeEngine.save_snapshot` writes all HOST state (the
  scheduler's continuation view of every live request, emitted tokens,
  terminal statuses, counters) as one JSON blob through
  ``train/checkpoint.py`` (manifest, CRC, ladder). A fresh engine's
  :meth:`ServeEngine.restore_latest_snapshot` takes the newest valid one;
  the pool is never saved: residents re-enter as queued continuations and
  re-prefill through the same captured chunk and decode graphs, and every
  stream continues bitwise the uninterrupted engine's. On the card a
  continuation re-prefills only its prompt and feeds the tokens it had
  emitted back through decode steps (the scheduler's ``"replay"``): a
  prefill chunk sums attention in another order than the decode step
  that first wrote those rows, and its bits would move later tokens.

Where a tick's host time goes: each tick is a span (``obs/tracing.span``)
in phases, whose seconds and counts ``tick_phases`` sums, always on, and
which are ``record_function`` ranges while a profiler runs:
``serve.tick`` all of :meth:`ServeEngine.step`; ``serve.schedule`` chaos,
pressure, sweep, prefetch, admission, the plan and the launch identity;
``serve.pack`` the step's host arrays; ``serve.launch`` the guarded
launch (the inputs' copy into the graph's buffer and the replay's
enqueue); ``serve.readback`` the host's wait for the launch's tokens;
``serve.apply`` the results applied and the tick's events made.
``last_tick_s`` spans pack to apply of a launching tick.

The host side (:class:`~.scheduler.Scheduler`, the block pool, the
prefix index) is the JAX package's, copied.
"""

from __future__ import annotations

import dataclasses
import glob
import io
import json
import os
import time
import zipfile
import zlib
from types import SimpleNamespace

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.core import precision
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.dist import (
    retry_with_backoff,
)
from distributed_tensorflow_guide_tpu_torch.core.graphs import CapturedStep
from distributed_tensorflow_guide_tpu_torch.models.generation import (
    _sample,
    decode_config,
    decode_split_config,
    fold_in,
    host_array,
    sample_rows,
)
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    moe_census_sum,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.obs.tracing import (
    PhaseStats,
    span,
)
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    BlockStore,
    table_row,
)
from distributed_tensorflow_guide_tpu_torch.serve.prefix_index import (
    CACHE_RID,
)
from distributed_tensorflow_guide_tpu_torch.serve.scheduler import (
    DECODE,
    PREFILL,
    EngineOverloaded,
    Request,
    Scheduler,
)
from distributed_tensorflow_guide_tpu_torch.utils.watchdog import (
    Watchdog,
    WatchdogTimeout,
)

__all__ = ["Event", "Request", "ServeEngine", "EngineOverloaded",
           "WatchdogTimeout", "adapter_bank_shapes", "build_step_fns",
           "init_adapter_bank", "paged_cache_pool", "paged_config"]

# pool-pressure chaos faults allocate under this reserved owner id (real
# rids are non-negative) and release after this many engine ticks
_CHAOS_RID = -7
_PRESSURE_HOLD_TICKS = 4


@dataclasses.dataclass(frozen=True)
class Event:
    """One streamed token: ``first`` marks the request's first generated
    token (TTFT edge), ``done`` its completion. Terminal lifecycle events
    (cancellation, deadline breach) carry ``token == -1``, ``done=True``
    and ``status`` in {"cancelled", "expired"}; real tokens are
    ``status == "ok"``."""

    time: float
    rid: int
    token: int
    first: bool
    done: bool
    status: str = "ok"


def paged_config(cfg: TransformerConfig, *, num_blocks: int,
                 block_size: int) -> TransformerConfig:
    """The serving view of a training config, paged flavour."""
    return dataclasses.replace(decode_config(cfg),
                               paged_num_blocks=num_blocks,
                               paged_block_size=block_size)


def paged_cache_pool(model: Transformer) -> list[dict]:
    """The zeroed block pool of a paged model view (one dict per layer)."""
    return model.init_pool()


def adapter_bank_shapes(cfg: TransformerConfig) -> dict:
    """name -> (shape, dtype) of the multi-LoRA delta banks of ``cfg``
    (``blocks.{i}.attn.qkv_A`` (n, d_model, r), ``..._B`` (n, r, 3 * H *
    hd), and likewise ``proj``, ``mlp.up``, ``mlp.down``; n =
    ``lora_adapters + 1``), read off the model itself, so a bank can never
    drift from what the steps read. Requires ``cfg.lora_rank``."""
    if cfg.lora_rank is None:
        raise ValueError("adapter_bank_shapes requires cfg.lora_rank")
    with torch.device("meta"):
        model = Transformer(cfg)
    return {name: (tuple(b.shape), b.dtype)
            for name, b in model.adapter_bank().items()}


def init_adapter_bank(cfg: TransformerConfig, device=None) -> dict:
    """A zeroed adapter bank: every id (each non-zero one included) is
    bitwise the base model until its rows are written."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in adapter_bank_shapes(cfg).items()}


def pool_leaves(pool: list[dict]) -> list[torch.Tensor]:
    """The pool's leaves in payload order: per layer ``k``, ``v`` and,
    for an int8 pool, the ``ks`` / ``vs`` scale rows."""
    return [layer[name] for layer in pool
            for name in ("k", "v", "ks", "vs") if name in layer]


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a pool leaf's rows travel as on the host: the
    leaf's own, or the raw 16-bit pattern for bfloat16 (numpy has
    none)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


class KVMover:
    """Moves whole pool blocks between the device pool and host payloads
    (one numpy array per pool leaf, shaped like one block of it: the
    :class:`~.paged_cache.BlockStore`'s unit).

    :meth:`d2h` gathers any number of blocks with ONE ``index_select``
    per leaf into one device staging buffer (leaf-major, each leaf's rows
    contiguous) and brings it back with ONE copy into a pinned host
    buffer; :meth:`h2d` packs the payloads into a pinned buffer, sends it
    with ONE copy and writes each leaf with ONE ``index_copy_``. The
    pool is written in place, so the captured step graphs, which hold its
    addresses, read the swapped-in rows at their next replay. Both run on
    the current stream, ordered with the steps; a d2h waits for its copy
    before it reads the host buffer, and an h2d waits for the previous
    one's copy before it refills the pinned buffer. On the CPU the
    staging buffer is the host buffer and nothing is pinned. There is no
    per-block fallback: a failed gather or scatter raises."""

    def __init__(self, pool: list[dict], device: torch.device):
        self.leaves = pool_leaves(pool)
        self.device = device
        self.cuda = device.type == "cuda"
        self.row_shapes = [tuple(leaf.shape[1:]) for leaf in self.leaves]
        self.row_bytes = [int(np.prod(sh)) * leaf.element_size()
                          for sh, leaf in zip(self.row_shapes, self.leaves)]
        self.np_dtypes = [_np_dtype(leaf.dtype) for leaf in self.leaves]
        self.block_bytes = sum(self.row_bytes)
        self._stage = None                   # device (or CPU) staging
        self._pinned = {"d2h": None, "h2d": None}
        self._h2d_done = None                # event of the last h2d copy

    def signature(self) -> list:
        """Per leaf ``[row shape, dtype]``: what a persisted payload must
        match to be taken back."""
        return [[list(sh), str(leaf.dtype)]
                for sh, leaf in zip(self.row_shapes, self.leaves)]

    def _layout(self, n: int) -> tuple[list[int], int]:
        offs, at = [], 0
        for rb in self.row_bytes:
            offs.append(at)
            at += -(-(n * rb) // 16) * 16  # 16-byte aligned segments
        return offs, at

    def _buffer(self, which: str, nbytes: int) -> torch.Tensor:
        if which == "stage":
            buf = self._stage
            if buf is None or buf.numel() < nbytes:
                buf = self._stage = torch.empty(
                    nbytes, dtype=torch.uint8, device=self.device)
            return buf
        buf = self._pinned[which]
        if buf is None or buf.numel() < nbytes:
            buf = self._pinned[which] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=True)
        return buf

    def _views(self, buf: torch.Tensor, offs: list[int], n: int):
        return [buf[off:off + n * rb].view(leaf.dtype).view((n,) + sh)
                for leaf, off, rb, sh in zip(self.leaves, offs,
                                             self.row_bytes,
                                             self.row_shapes)]

    @torch.inference_mode()
    def d2h(self, blocks: list[int]) -> list[list[np.ndarray]]:
        """Copies of ``blocks``' rows, one payload per block."""
        n = len(blocks)
        if not n:
            return []
        offs, total = self._layout(n)
        idx = torch.as_tensor(blocks, dtype=torch.int64).to(self.device)
        stage = self._buffer("stage", total)
        for leaf, view in zip(self.leaves, self._views(stage, offs, n)):
            torch.index_select(leaf, 0, idx, out=view)
        host = stage
        if self.cuda:
            host = self._buffer("d2h", total)
            host[:total].copy_(stage[:total], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        raw = host[:total].numpy()
        return [[raw[off + j * rb:off + (j + 1) * rb].copy()
                 .view(dt).reshape(sh)
                 for off, rb, dt, sh in zip(offs, self.row_bytes,
                                            self.np_dtypes,
                                            self.row_shapes)]
                for j in range(n)]

    @torch.inference_mode()
    def h2d(self, blocks: list[int],
            payloads: list[list[np.ndarray]]) -> None:
        """Write ``payloads[j]`` into pool block ``blocks[j]``, in
        place."""
        n = len(blocks)
        if n != len(payloads):
            raise ValueError(f"{n} blocks for {len(payloads)} payloads")
        if not n:
            return
        offs, total = self._layout(n)
        if self.cuda:
            if self._h2d_done is not None:
                self._h2d_done.synchronize()
            host = self._buffer("h2d", total)
        else:
            host = self._buffer("stage", total)
        raw = host[:total].numpy()
        for i, (off, rb, sh) in enumerate(zip(offs, self.row_bytes,
                                              self.row_shapes)):
            for j, p in enumerate(payloads):
                a = np.ascontiguousarray(p[i])
                if a.nbytes != rb or tuple(a.shape) != sh:
                    raise ValueError(
                        f"payload leaf {i} is {a.shape} ({a.nbytes} "
                        f"bytes), the pool's rows are {sh} ({rb} bytes)")
                raw[off + j * rb:off + (j + 1) * rb] = a.view(
                    np.uint8).reshape(-1)
        stage = host
        if self.cuda:
            stage = self._buffer("stage", total)
            stage[:total].copy_(host[:total], non_blocking=True)
            self._h2d_done = torch.cuda.Event()
            self._h2d_done.record()
        idx = torch.as_tensor(blocks, dtype=torch.int64).to(self.device)
        for leaf, view in zip(self.leaves, self._views(stage, offs, n)):
            leaf.index_copy_(0, idx, view)


class _Packed:
    """A step's host inputs as one int64 vector: ``fields`` are (name,
    shape, dtype) in order; :meth:`host` packs numpy arrays, :meth:`views`
    cuts a device copy back into tensors of the step's dtypes."""

    def __init__(self, fields):
        self.fields = [f for f in fields if f is not None]
        self.size = sum(int(np.prod(shape)) for _, shape, _ in self.fields)

    def host(self, arrays) -> np.ndarray:
        out = np.empty(self.size, np.int64)
        at = 0
        for (name, shape, _), a in zip(self.fields, arrays, strict=True):
            n = int(np.prod(shape))
            out[at:at + n] = np.asarray(a, np.int64).reshape(n)
            at += n
        return out

    def views(self, buf: torch.Tensor) -> dict:
        out, at = {}, 0
        for name, shape, dtype in self.fields:
            n = int(np.prod(shape))
            out[name] = buf[at:at + n].view(shape).to(dtype)
            at += n
        return out


class _Step:
    """One step function fed host arrays: ``step(model, pool, *arrays)``.

    Eager (the CPU, and ``fns.decode_fn`` / ``fns.prefill_fn`` on the
    card): one host-to-device copy of the packed inputs, then the step.
    Captured (the card): the first call binds the model view and the pool,
    and a :class:`CapturedStep` captures the step over one static device
    buffer; every call packs its inputs into a pinned buffer, copies it
    into the static one and replays (a retried launch does both again).
    The capture's warm-up runs the first call's real inputs, which the
    replay then repeats: it writes the same k/v to the same rows."""

    def __init__(self, body, packed: _Packed, *, capture: bool):
        self.body, self.packed, self.capture = body, packed, capture
        self.step = self.model = self.pool = None

    @property
    def captures(self) -> int:
        return 0 if self.step is None else self.step.captures

    def release(self) -> None:
        """Drop the captured graph (and its private memory pool) and the
        model view, pool and buffers it was captured over."""
        self.step = self.model = self.pool = None
        self.stage = self.static = None

    @torch.inference_mode()
    def __call__(self, model, pool, *arrays):
        host = self.packed.host(arrays)
        if not self.capture:
            buf = torch.as_tensor(host, device=model.device)
            return self.body(model, pool, self.packed.views(buf))
        if self.step is None:
            self.model, self.pool = model, pool
            self.stage = torch.empty(self.packed.size, dtype=torch.int64,
                                     pin_memory=True)
            self.static = torch.empty(self.packed.size, dtype=torch.int64,
                                      device=model.device)
            body, packed, static = self.body, self.packed, self.static
            self.step = CapturedStep(
                lambda: body(model, pool, packed.views(static)),
                device=model.device)
        elif model is not self.model or pool is not self.pool:
            raise ValueError("a captured step replays over the model view "
                             "and pool it was captured with")
        self.stage.numpy()[:] = host
        self.static.copy_(self.stage, non_blocking=True)
        return self.step()


@dataclasses.dataclass
class StepFns:
    """The engine's two steps: ``decode`` and ``prefill`` (captured on the
    card), ``decode_fn`` and ``prefill_fn`` (the same steps, eager)."""

    cfg: TransformerConfig
    n_blk: int
    sampled: bool
    lora: bool
    moe: bool
    decode_fn: _Step
    prefill_fn: _Step
    decode: object = None
    prefill: object = None

    @property
    def captures(self) -> dict:
        """Graph captures so far, per step (one each over an engine's
        life on the card; none on the CPU)."""
        return {name: getattr(getattr(self, name), "captures", 0)
                for name in ("decode", "prefill")}


def build_step_fns(cfg: TransformerConfig, *, slots: int, num_blocks: int,
                   block_size: int, prefill_chunk: int,
                   temperature: float = 0.0, top_k: int | None = None,
                   device=None) -> StepFns:
    """The two step functions, ``step(model view, pool, *host arrays)``;
    both update the pool in place and return device tokens:

    * ``decode(model, pool, tables (S, n_blk), written (S,), last_tok
      (S,), pos_keys (S, 2) | None, adapter_ids (S,) | None)`` -> (S,);
    * ``prefill(model, pool, tables (1, n_blk), start (1,), chunk (1,
      CH), valid (1,), pos_key (2,) | None, adapter_id (1,) | None)`` ->
      (1,).

    ``pos_keys`` are each slot's key of the position it samples, folded
    on the host (absent when greedy); adapter ids only with
    ``cfg.lora_rank``. With ``cfg.moe_experts`` the output carries the
    census after the tokens, int64: decode (S,) tokens, (S,) overflow
    flags, (E,) load, (E,) overflow; prefill (1,) token, (E,) load, (E,)
    overflow. On ``device`` "cuda" ``decode`` and ``prefill`` are
    captured (see :class:`_Step`)."""
    n_blk = cfg.max_len // block_size
    pcfg = decode_split_config(
        paged_config(cfg, num_blocks=num_blocks, block_size=block_size),
        resolve_device(device), batch=slots, block_size=block_size,
        n_blk=n_blk)
    sampled, lora, moe = temperature != 0.0, pcfg.lora, pcfg.moe
    S, CH = slots, prefill_chunk
    i32, i64 = torch.int32, torch.int64

    def decode_step(model, pool, x):
        """(S,) tokens in, (S,) tokens out (with the MoE census)."""
        census = [] if moe else None
        logits = model(x["last_tok"][:, None], x["written"], cache=pool,
                       block_tables=x["tables"], adapter=x.get("ids"),
                       moe_mask=x["written"] > 0 if moe else None,
                       moe_census=census)
        nxt = sample_rows(logits[:, -1], x.get("keys"), temperature, top_k)
        if not moe:
            return nxt
        load, overflow, of_tok = moe_census_sum(census)
        return torch.cat([nxt.to(i64), (of_tok > 0).to(i64), load,
                          overflow])

    def prefill_chunk_step(model, pool, x):
        """One (1, CH) slice of one prompt. ``valid`` rows are real
        prompt; the rest are pads whose writes land inside the request's
        blocks and are overwritten or masked forever (and which the MoE
        router skips). The sample comes from row ``valid - 1`` (read on
        the device) with the key of absolute position ``start +
        valid``."""
        census = [] if moe else None
        mask = (torch.arange(CH, device=x["valid"].device)[None, :]
                < x["valid"]) if moe else None
        logits = model(x["chunk"], x["start"], cache=pool,
                       block_tables=x["tables"], adapter=x.get("ids"),
                       moe_mask=mask, moe_census=census)
        last = logits[0].index_select(0, x["valid"] - 1)  # (1, V)
        tok = _sample(last, x.get("key"), temperature, top_k)
        if not moe:
            return tok
        load, overflow, _ = moe_census_sum(census)
        return torch.cat([tok.to(i64), load, overflow])

    decode_in = _Packed([
        ("tables", (S, n_blk), i32), ("written", (S,), i32),
        ("last_tok", (S,), i64),
        ("keys", (S, 2), i64) if sampled else None,
        ("ids", (S,), i64) if lora else None])
    prefill_in = _Packed([
        ("tables", (1, n_blk), i32), ("start", (1,), i32),
        ("chunk", (1, CH), i64), ("valid", (1,), i64),
        ("key", (2,), i64) if sampled else None,
        ("ids", (1,), i64) if lora else None])
    capture = resolve_device(device).type == "cuda"
    fns = StepFns(cfg=pcfg, n_blk=n_blk, sampled=sampled, lora=lora,
                  moe=moe,
                  decode_fn=_Step(decode_step, decode_in, capture=False),
                  prefill_fn=_Step(prefill_chunk_step, prefill_in,
                                   capture=False))
    fns.decode = (_Step(decode_step, decode_in, capture=True) if capture
                  else fns.decode_fn)
    fns.prefill = (_Step(prefill_chunk_step, prefill_in, capture=True)
                   if capture else fns.prefill_fn)
    return fns


class ServeEngine:
    """The serving loop: host scheduling around the two step functions.

    >>> eng = ServeEngine(cfg, model, slots=4, num_blocks=33,
    ...                   block_size=8, prefill_chunk=16)
    >>> eng.submit(Request(rid=0, prompt=toks, max_new_tokens=16,
    ...                    rng=np.array([0, 7], np.uint32)))
    >>> events = eng.run()          # drain everything (virtual time)
    >>> eng.completions()[0]        # the request's generated tokens

    ``model`` is a :class:`Transformer` holding the weights, on
    ``device`` (default the first CUDA card; ``device="cpu"`` only when
    asked for). With ``cfg.lora_rank``, ``adapters`` is the delta bank
    (name -> array, :func:`init_adapter_bank`'s names; zeros by default),
    copied into the engine's model view; ``Request.adapter`` picks a
    request's row. ``engine.adapters`` holds the live banks: write new
    adapter weights into them in place (:meth:`load_adapter_bank`).

    ``online_tune`` (True / False; None inherits ``DTG_ONLINE_TUNE``)
    sets the tuning table's process-wide online override before the
    step functions resolve the decode split (``ops/autotune.py``).

    Resilience (see the module docstring): ``chaos`` a
    ``testing.chaos.FaultSchedule`` whose serve kinds fire at engine
    ticks, ``burst_factory(n, now[, tenant]) -> [Request]`` for its
    arrival bursts, ``step_deadline_s`` a watchdog deadline on each
    launch attempt (it must cover a first call's capture),
    ``snapshot_dir`` / ``snapshot_keep`` where :meth:`save_snapshot`
    writes and how many snapshots it keeps. A preempted or restored
    stream rebuilds its cache by feeding its emitted tokens back through
    decode steps on the card, where a prefill chunk would write their rows
    with other bits, and by re-prefilling them on the CPU, as the JAX
    engine does (:class:`~.scheduler.Scheduler`'s ``continuations``).
    """

    def __init__(self, cfg: TransformerConfig, model: Transformer, *,
                 slots: int, num_blocks: int, block_size: int,
                 prefill_chunk: int, temperature: float = 0.0,
                 top_k: int | None = None, max_queue: int | None = None,
                 retry_attempts: int = 3, retry_base_delay_s: float = 0.05,
                 prefix_cache: bool = False, tenant_quotas=None,
                 drr_quantum: int | None = None, recorder=None,
                 adapters=None, chaos=None, burst_factory=None,
                 step_deadline_s: float | None = None,
                 snapshot_dir=None, snapshot_keep: int = 3,
                 host_blocks: int = 0, persist_cache: bool = False,
                 continuations: str | None = None, device=None,
                 online_tune: bool | None = None):
        # online in-situ tuning: True / False set the process-wide
        # override (the tuning table is process state, so the knob is
        # too: ``autotune.set_online_tune``), None inherits
        # DTG_ONLINE_TUNE. The step functions below resolve the decode
        # split once, before any capture; on the CPU it is the default.
        if online_tune is not None:
            from distributed_tensorflow_guide_tpu_torch.ops import autotune

            autotune.set_online_tune(online_tune)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if cfg.weight_dtype == "fp8":
            precision.require_fp8(self.device)
        if host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
        if persist_cache:
            if snapshot_dir is None:
                raise ValueError(
                    "persist_cache requires ServeEngine(snapshot_dir=...)")
            if not prefix_cache:
                raise ValueError(
                    "persist_cache requires prefix_cache=True (the trie "
                    "is what indexes the persisted blocks)")
            if not host_blocks:
                raise ValueError(
                    "persist_cache requires host_blocks > 0 (restored "
                    "cache contents land in the host tier)")
        if continuations is None:
            continuations = "replay" if self.device.type == "cuda" \
                else "prefill"
        if continuations not in ("prefill", "replay"):
            raise ValueError(f"continuations must be 'prefill' or "
                             f"'replay', got {continuations!r}")
        self.fns = build_step_fns(cfg, slots=slots, num_blocks=num_blocks,
                                  block_size=block_size,
                                  prefill_chunk=prefill_chunk,
                                  temperature=temperature, top_k=top_k,
                                  device=self.device)
        self.model = model.with_config(self.fns.cfg)
        if self.fns.lora:
            self.model.set_adapter_bank(
                adapters if adapters is not None
                else init_adapter_bank(self.fns.cfg))
            self.adapters = self.model.adapter_bank()
        elif adapters is not None:
            raise ValueError(
                "ServeEngine(adapters=...) requires cfg.lora_rank")
        else:
            self.adapters = None
        self.num_slots = slots
        self.rec = recorder if recorder is not None else obs_events.current()
        self.pool = paged_cache_pool(self.model)
        # the host spill tier: host_blocks > 0 puts a host-RAM store of
        # that many blocks under the pool. Preemption and trie eviction
        # then demote instead of destroy, and the scheduler swaps demoted
        # blocks back in (prefetched ahead of admission) through the
        # KVMover's fused copies, which write the pool in place and
        # never touch the step graphs. 0 = off.
        self.persist_cache = bool(persist_cache)
        self.store = BlockStore(capacity=host_blocks) if host_blocks else None
        self.kv = KVMover(self.pool, self.device)
        self.sched = Scheduler(
            slots=slots, num_blocks=num_blocks, block_size=block_size,
            prefill_chunk=prefill_chunk, max_len=self.fns.cfg.max_len,
            max_queue=max_queue, prefix_cache=prefix_cache,
            tenant_quotas=tenant_quotas, drr_quantum=drr_quantum,
            host_store=self.store,
            cache_io=(SimpleNamespace(d2h_many=self.kv.d2h,
                                      h2d_many=self.kv.h2d)
                      if self.store is not None else None),
            recorder=self.rec)
        self.sched.continuations = continuations
        self._trash_row = table_row(
            [], self.fns.n_blk, self.sched.pool.trash_block)
        self.steps = {"decode": 0, "prefill": 0, "idle": 0}
        # the MoE census: per-expert load and overflow summed over launches
        # and layers, and the stalls (a stalled slot-tick is one discarded
        # sample)
        if self.fns.moe:
            n_e = self.fns.cfg.moe_experts
            self._moe_load = np.zeros((n_e,), np.int64)
            self._moe_overflow = np.zeros((n_e,), np.int64)
            self._moe_stall_slot_ticks = 0
            self._moe_stall_ticks = 0
        self.retry_attempts = retry_attempts
        self.retry_base_delay_s = retry_base_delay_s
        self.chaos = chaos
        self.burst_factory = burst_factory
        self._injected_exc = 0  # pending chaos launch failures
        self._pressure_holds: list[tuple[float, list[int]]] = []
        # every failed launch attempt (retried-and-recovered ones included)
        self.launch_failures = 0
        self._tick = 0
        self._ttft_ewma: float | None = None  # predicted-TTFT shed gate
        self.last_tick_s = 0.0
        self.tick_phases = PhaseStats()  # host seconds per tick phase
        self._step_deadline_s = step_deadline_s
        self._watchdog = (Watchdog(name="serve-engine", recorder=self.rec)
                          if step_deadline_s else None)
        self.snapshot_dir = snapshot_dir
        self._ckpt = None
        self._last_snap = -1
        if snapshot_dir is not None:
            from distributed_tensorflow_guide_tpu_torch.train.checkpoint \
                import Checkpointer

            self._ckpt = Checkpointer(snapshot_dir, max_to_keep=snapshot_keep,
                                      recorder=self.rec)

    # ---- intake ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue ``req``. Its prompt and rng may be lists, numpy arrays or
        tensors on any device: the scheduler keeps them on the host, so a
        tensor is read there once."""
        prompt = host_array(req.prompt, np.int32).reshape(-1)
        if prompt.size and int(prompt.max()) >= self.fns.cfg.vocab_size:
            raise ValueError("prompt token out of vocabulary")
        if self.fns.lora:
            if not 0 <= req.adapter <= self.fns.cfg.lora_adapters:
                raise ValueError(
                    f"request {req.rid} adapter {req.adapter} out of "
                    f"range [0, {self.fns.cfg.lora_adapters}]")
        elif req.adapter != 0:
            raise ValueError(
                f"request {req.rid} names adapter {req.adapter} but the "
                "engine config has no lora_rank")
        # predicted-SLO gate: if recent TTFTs already blow this request's
        # TTFT budget, admitting it is a guaranteed miss that would also
        # push every queued request further out — shed at the door
        # (retriable; nothing recorded). Queue-depth shedding lives in
        # Scheduler.submit behind max_queue.
        if (req.ttft_deadline_s is not None
                and self._ttft_ewma is not None
                and self._ttft_ewma > req.ttft_deadline_s):
            self.sched.shed += 1
            if self.rec.enabled:
                self.rec.emit(
                    "req.shed", cat="serve", actor="engine",
                    payload={"rid": req.rid, "reason": "ttft",
                             "tenant": int(req.tenant),
                             "ttft_s": self._ttft_ewma},
                    t=float(req.arrival))
            raise EngineOverloaded(
                f"request {req.rid} shed: recent TTFT "
                f"{self._ttft_ewma:.3f}s exceeds its "
                f"{req.ttft_deadline_s:.3f}s deadline — retry later")
        self.sched.submit(dataclasses.replace(
            req, prompt=prompt, rng=host_array(req.rng, np.uint32)))
        if self.rec.enabled:
            self.rec.emit(
                "req.submit", cat="serve", actor="engine",
                payload={"rid": req.rid, "tenant": int(req.tenant),
                         "adapter": int(req.adapter),
                         "prompt_len": int(prompt.size),
                         "max_new": int(req.max_new_tokens)},
                t=float(req.arrival))

    def load_adapter_bank(self, bank) -> None:
        """Write ``bank`` (name -> array, every name of
        :func:`adapter_bank_shapes`) into the live banks in place: the
        captured steps read the new weights at their next replay, with no
        recapture."""
        if self.adapters is None:
            raise ValueError("this engine serves no adapters")
        with torch.inference_mode():
            for name, buf in self.adapters.items():
                buf.copy_(torch.as_tensor(bank[name]))

    def cancel(self, rid: int) -> bool:
        """Client abandon: free the stream's slot+blocks at the next step
        boundary. Returns False for unknown/already-terminal rids."""
        return self.sched.cancel(rid)

    # ---- stream export / adoption (the fleet's migration seam) -----------

    def export_stream(self, rid: int, *, with_kv: bool = True) -> dict:
        """Detach a live stream into a portable migration record for
        another replica's :meth:`adopt_stream`. ``with_kv=True`` copies
        the stream's written KV blocks to the host (one fused gather)
        BEFORE the scheduler frees them, so a decode-phase stream resumes
        at the target by swap-in; ``with_kv=False`` ships the
        continuation alone, in the engine's continuations form (the
        target rebuilds the cache: the same stream bitwise either way).
        ``payload_bytes`` is what the transfer moves."""
        keep = self.sched.migratable_blocks(rid) if with_kv else []
        payloads = self.kv.d2h(keep) if keep else []
        record = self.sched.detach_stream(rid)
        record["payloads"] = payloads
        record["payload_bytes"] = sum(
            int(a.nbytes) for p in payloads for a in p)
        return record

    def adopt_stream(self, record: dict) -> None:
        """Adopt a stream another replica exported. KV payloads land in
        THIS engine's host spill store and the stream resumes by the
        normal swap-in path at its next admission; ``submitted`` is never
        recounted. A record of the other continuations form raises
        (:meth:`~.scheduler.Scheduler.attach_stream`)."""
        if record.get("payloads") and self.store is None:
            raise RuntimeError(
                "adopting KV payloads needs ServeEngine(host_blocks>0) "
                "(the adoption landing pad); export with_kv=False to "
                "rebuild the cache instead")
        self.sched.attach_stream(record)

    # ---- the tick --------------------------------------------------------

    def step(self, now: float = 0.0) -> tuple[list[Event], str]:
        """One engine tick: apply due chaos faults, sweep lifecycle
        (cancellations / deadlines), admit arrived requests, launch (at
        most) one step, apply its results. Returns (events, kind) with
        kind in {"prefill", "decode", "idle"}."""
        with span(None, "serve.tick", stats=self.tick_phases):
            return self._step(now)

    def _step(self, now: float) -> tuple[list[Event], str]:
        tick = self._tick
        self._tick += 1
        rec = self.rec
        with span(None, "serve.schedule", stats=self.tick_phases):
            if rec.enabled:
                self.sched.now = now  # timestamps scheduler decisions
            if self.chaos is not None:
                if rec.enabled:
                    self.chaos.recorder = rec
                    self.chaos.obs_now = now
                self._apply_chaos(tick, now)
            self._release_pressure(tick)
            events = [Event(now, *t) for t in self.sched.sweep(now)]
            if self.store is not None:
                # queued spilled continuations' h2d copies land now,
                # ahead of the admission that resumes them
                self.sched.prefetch()
            self.sched.admit(now)
            kind, arg = self.sched.plan()
            launch = None
            if rec.enabled and kind != "idle":
                # capture launch identity BEFORE the step runs: apply_*
                # frees a slot the moment its request completes
                if kind == PREFILL:
                    s = self.sched.slots[arg]
                    launch = {"slot": arg, "rid": s.rid,
                              "chunk": s.chunk_cursor}
                else:
                    launch = {"slots": list(arg),
                              "rids": [self.sched.slots[i].rid
                                       for i in arg]}
        t0 = time.perf_counter()
        if kind == PREFILL:
            events.extend(self._run_prefill(arg, now))
        elif kind == DECODE:
            events.extend(self._run_decode(arg, now))
        self.last_tick_s = time.perf_counter() - t0
        self.steps[kind] += 1
        if launch is not None:
            launch["tick"] = tick
            launch["dur_s"] = self.last_tick_s
            rec.emit(f"{kind}.launch", cat="serve", actor="engine",
                     payload=launch, t=now)
        for e in events:
            if e.first and e.status == "ok":
                arrival = self.sched.meta.get(e.rid, (now, None, None))[0]
                ttft = max(0.0, now - arrival)
                if np.isfinite(ttft):
                    self._ttft_ewma = (
                        ttft if self._ttft_ewma is None
                        else 0.8 * self._ttft_ewma + 0.2 * ttft)
        if rec.enabled and events:
            self._emit_lifecycle(events, now, tick)
        return events, kind

    def _emit_lifecycle(self, events: list[Event], now: float,
                        tick: int) -> None:
        """Map the tick's swept/produced events onto recorder instants."""
        rec = self.rec
        for e in events:
            if e.status != "ok":
                rec.emit(f"req.{e.status}", cat="serve", actor="engine",
                         payload={"rid": e.rid, "tick": tick}, t=now)
                continue
            if e.first:
                payload = {"rid": e.rid, "tick": tick}
                arrival = self.sched.meta.get(e.rid, (now, None, None))[0]
                ttft = now - arrival
                if np.isfinite(ttft):
                    payload["ttft_s"] = float(max(0.0, ttft))
                rec.emit("req.first_token", cat="serve", actor="engine",
                         payload=payload, t=now)
            if e.done:
                rec.emit("req.done", cat="serve", actor="engine",
                         payload={"rid": e.rid, "tick": tick,
                                  "tokens": len(self.sched.emitted.get(
                                      e.rid, []))},
                         t=now)

    def _launch(self, fn, tag: str):
        """One guarded step launch: a per-attempt watchdog deadline (with
        ``step_deadline_s``) inside ``retry_with_backoff``. Every launch
        input is rebuilt from host state (a captured step copies it into
        its static buffer again and replays) and the sampling seeds are
        position-derived, so a retried launch re-runs the same tick
        bitwise. An injected chaos failure fires before the step runs,
        with the pool untouched."""

        def attempt():
            try:
                if self._injected_exc:
                    self._injected_exc -= 1
                    from distributed_tensorflow_guide_tpu_torch.testing \
                        .chaos import ChaosInjectedError
                    raise ChaosInjectedError(
                        f"chaos: injected serve step exception ({tag})")
                wd = self._watchdog
                if wd is None:
                    return fn()
                wd.arm(tag, self._step_deadline_s)
                try:
                    return fn()
                except KeyboardInterrupt:
                    wd.check()  # the trip as the clean, retriable error
                    raise
                finally:
                    wd.disarm()
            except Exception:
                self.launch_failures += 1
                raise

        return retry_with_backoff(
            attempt, attempts=self.retry_attempts,
            base_delay_s=self.retry_base_delay_s, max_delay_s=1.0,
            what=tag)

    def _run_prefill(self, i: int, now: float) -> list[Event]:
        phases = self.tick_phases
        with span(None, "serve.pack", stats=phases):
            s = self.sched.slots[i]
            CH = self.sched.prefill_chunk
            start = s.chunk_cursor * CH
            valid = min(CH, len(s.prompt) - start)
            chunk = np.zeros((1, CH), np.int64)
            chunk[0, :valid] = s.prompt[start:start + valid]
            tables = table_row(s.blocks, self.fns.n_blk,
                               self.sched.pool.trash_block)[None]
            # the sample's key, folded on the host: greedy derives none
            args = [self.model, self.pool, tables, [start], chunk, [valid]]
            if self.fns.sampled:
                args.append(fold_in(s.rng, start + valid))
            if self.fns.lora:
                args.append([s.adapter])
        with span(None, "serve.launch", stats=phases):
            out = self._launch(lambda: self.fns.prefill(*args),
                               tag="serve_prefill_chunk_step")
        with span(None, "serve.readback", stats=phases):
            out = out.tolist()
        with span(None, "serve.apply", stats=phases):
            if self.fns.moe:
                self._add_census(out[1:])
            return [Event(now, *ev) for ev in
                    self.sched.apply_prefill(i, int(out[0]))]

    def _add_census(self, loads: list) -> None:
        """Fold one launch's (E,) load and (E,) overflow into the
        engine's census."""
        n_e = len(self._moe_load)
        self._moe_load += np.asarray(loads[:n_e], np.int64)
        self._moe_overflow += np.asarray(loads[n_e:], np.int64)

    def _run_decode(self, ready: list[int], now: float) -> list[Event]:
        phases = self.tick_phases
        S, n_blk = self.num_slots, self.fns.n_blk
        with span(None, "serve.pack", stats=phases):
            tables = np.tile(self._trash_row, (S, 1))
            written = np.zeros((S,), np.int32)
            last_tok = np.zeros((S,), np.int64)
            keys = np.zeros((S, 2), np.int64)
            adapter_ids = np.zeros((S,), np.int64)
            for i in ready:
                s = self.sched.slots[i]
                tables[i] = table_row(s.blocks, n_blk,
                                      self.sched.pool.trash_block)
                written[i] = s.written
                last_tok[i] = s.pending
                keys[i] = s.rng
                adapter_ids[i] = s.adapter
            args = [self.model, self.pool, tables, written, last_tok]
            if self.fns.sampled:
                args.append(fold_in(keys, written.astype(np.int64) + 1))
            if self.fns.lora:
                args.append(adapter_ids)
        with span(None, "serve.launch", stats=phases):
            nxt = self._launch(lambda: self.fns.decode(*args),
                               tag="serve_decode_step")
        with span(None, "serve.readback", stats=phases):
            nxt = nxt.tolist()
        with span(None, "serve.apply", stats=phases):
            overflowed = [False] * S
            if self.fns.moe:
                overflowed = nxt[S:2 * S]
                self._add_census(nxt[2 * S:])
            events = []
            stalled = 0
            for i in ready:
                if overflowed[i]:
                    # degrade-to-overflow: the token skipped its expert in
                    # some layer; discard it and retry the same token next
                    # tick (pending and written untouched)
                    stalled += 1
                    continue
                events.extend(Event(now, *ev) for ev in
                              self.sched.apply_decode(i, int(nxt[i])))
            if stalled:
                self._moe_stall_slot_ticks += stalled
                self._moe_stall_ticks += 1
        return events

    # ---- chaos application (testing.chaos serve kinds) -------------------

    def _apply_chaos(self, tick: int, now: float) -> None:
        from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
            corrupt_checkpoint,
        )
        for f in self.chaos.take_serve(tick):
            if f.kind == "serve_step_exception":
                self._injected_exc += 1
            elif f.kind == "client_abandon":
                rid = self._abandon_target(int(f.param))
                if rid is not None:
                    self.cancel(rid)
            elif f.kind == "arrival_burst":
                if self.burst_factory is None:
                    raise ValueError(
                        "arrival_burst fault needs "
                        "ServeEngine(burst_factory=...)")
                reqs = (self.burst_factory(int(f.param), now)
                        if f.tenant is None
                        else self.burst_factory(int(f.param), now,
                                                int(f.tenant)))
                for req in reqs:
                    try:
                        self.submit(req)
                    except EngineOverloaded:
                        pass  # the gate shedding the burst IS the scenario
            elif f.kind == "pool_pressure":
                self._grab_pressure(tick, int(f.param))
            else:  # snapshot_truncate / snapshot_corrupt
                if self.snapshot_dir is None:
                    raise ValueError(
                        f"{f.kind} fault needs ServeEngine("
                        "snapshot_dir=...)")
                self._ckpt.wait()  # commit pending async saves first
                try:
                    corrupt_checkpoint(
                        self.snapshot_dir,
                        mode=("truncate" if f.kind == "snapshot_truncate"
                              else "flip"))
                except FileNotFoundError:
                    pass  # no committed snapshot yet: nothing to damage

    def _abandon_target(self, idx: int) -> int | None:
        live = sorted(
            {s.rid for s in self.sched.slots if s is not None}
            | {r.rid for r in self.sched.queue})
        if not live:
            return None
        return live[idx % len(live)]

    def _grab_pressure(self, tick: int, nblocks: int) -> None:
        """A co-tenant spike: blocks vanish from the pool for a few ticks
        under the reserved chaos owner, forcing evictions and re-prefills
        of residents; :meth:`_release_pressure` (or the end of
        :meth:`run`) gives them back."""
        pool = self.sched.pool
        n = min(nblocks, pool.free_blocks)
        if n <= 0:
            return
        blocks = pool.alloc(_CHAOS_RID, n)
        if blocks:
            self._pressure_holds.append(
                (tick + _PRESSURE_HOLD_TICKS, blocks))

    def _release_pressure(self, tick: float) -> None:
        keep = []
        for release_at, blocks in self._pressure_holds:
            if tick >= release_at:
                self.sched.pool.free(_CHAOS_RID, blocks)
            else:
                keep.append((release_at, blocks))
        self._pressure_holds = keep

    # ---- drain -----------------------------------------------------------

    def run(self, max_ticks: int | None = None) -> list[Event]:
        """Drain all submitted work ignoring arrival times (tick clock)."""
        events: list[Event] = []
        ticks = 0
        while self.sched.has_queued or self.sched.has_resident:
            evs, kind = self.step(now=float("inf"))
            events.extend(evs)
            if kind == "idle":
                if self._pressure_holds:
                    continue  # chaos holds blocks; they release by tick
                raise RuntimeError(
                    "engine deadlock: work queued but nothing schedulable")
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        self._release_pressure(float("inf"))
        return events

    def completions(self) -> dict[int, list[int]]:
        """rid -> every token emitted so far (complete or not)."""
        return {rid: list(toks)
                for rid, toks in self.sched.emitted.items()}

    def live_blocks(self) -> int:
        """Blocks currently owned by resident requests."""
        return self.sched.pool.live_blocks()

    def health(self) -> dict:
        """Engine health counters."""
        sd = self.sched
        return {
            "resident": sum(s is not None for s in sd.slots),
            "queued": len(sd.queue),
            "completed": len(sd.done),
            "shed": sd.shed,
            "cancelled": sd.cancelled,
            "expired": sd.expired,
            "preemptions": sd.preemptions,
            "live_blocks": sd.pool.live_blocks(),
            "prefix_hit_tokens": sd.prefix_hit_tokens,
            "prefill_tokens_saved": sd.prefill_tokens_saved,
            "prefix_evictions": sd.prefix_evictions,
            "prefix_nodes": sd.prefix.size if sd.prefix is not None else 0,
            "spill_out_blocks": sd.spill_out_blocks,
            "spill_in_blocks": sd.spill_in_blocks,
            "spill_d2h_bytes": sd.spill_d2h_bytes,
            "spill_h2d_bytes": sd.spill_h2d_bytes,
            "spill_prefetched_blocks": sd.spill_prefetched_blocks,
            "spill_resumes": sd.spill_resumes,
            "swapin_tokens_saved": sd.swapin_tokens_saved,
            "migrated_out": sd.migrated_out,
            "migrated_in": sd.migrated_in,
            "host_blocks": (self.store.live_blocks()
                            if self.store is not None else 0),
            "host_bytes": (self.store.bytes_stored()
                           if self.store is not None else 0),
            "tenants": {t: dict(c) for t, c in sorted(sd.tenants.items())},
            "last_tick_s": self.last_tick_s,
            "ticks": self._tick,
            "launch_failures": self.launch_failures,
            **({"moe": {
                "expert_load": [int(x) for x in self._moe_load],
                "expert_overflow": [int(x) for x in self._moe_overflow],
                "stall_slot_ticks": int(self._moe_stall_slot_ticks),
                "stall_ticks": int(self._moe_stall_ticks),
            }} if self.fns.moe else {}),
        }

    # ---- snapshot / restore ----------------------------------------------

    def save_snapshot(self, *, async_: bool = False) -> int | None:
        """Write ALL host-side serving state (the scheduler's continuation
        view of every live request, emitted tokens, terminal statuses,
        counters) as one uint8 JSON blob through the checkpointer, whose
        manifest's size and CRC cover it (``snapshot_truncate`` /
        ``snapshot_corrupt`` are both caught at restore). The pool is NOT
        saved. Returns the snapshot's label (the tick, or one past the
        last label), or None if the save was skipped."""
        if self._ckpt is None:
            raise ValueError("ServeEngine(snapshot_dir=...) not configured")
        state = {"sched": self.sched.snapshot_state(),
                 "tick": self._tick,
                 "steps": dict(self.steps)}
        blob = np.frombuffer(json.dumps(state).encode("utf-8"),
                             dtype=np.uint8).copy()
        label = max(self._tick, self._last_snap + 1)
        if not self._ckpt.save(label, {"blob": blob}, async_=async_):
            return None
        self._last_snap = label
        if self.persist_cache:
            self._save_cache_contents(label)
        if self.rec.enabled:
            self.rec.emit(
                "snapshot.save", cat="serve", actor="engine",
                payload={"label": int(label),
                         "requests": len(state["sched"]["requests"]),
                         "async": bool(async_)})
        return label

    def _cache_file(self, label: int) -> str:
        return os.path.join(str(self.snapshot_dir),
                            f"cache_{int(label)}.npz")

    def _save_cache_contents(self, label: int) -> int:
        """Persist the prefix trie's PAYLOADS (device-resident blocks
        copied to the host in one fused gather, spilled ones straight
        from the host tier) next to snapshot ``label`` as one npz plus a
        CRC sidecar (``cache_<label>.crc``): a restored engine takes them
        into its host tier and re-prefills ZERO cached-prefix tokens.
        Returns the number of nodes written."""
        sd = self.sched
        walked = list(sd.prefix.walk())
        on_dev = [node.block for _, _, node in walked
                  if node.block is not None]
        copies = iter(self.kv.d2h(on_dev))
        nodes, arrays = [], {}
        for j, (adapter, path, node) in enumerate(walked):
            payload = (next(copies) if node.block is not None
                       else sd.store.get(node.host))
            nodes.append({"adapter": int(adapter),
                          "path": [int(t) for t in path]})
            for k, a in enumerate(payload):
                arrays[f"n{j}_l{k}"] = np.asarray(a)
        meta = json.dumps({"version": 1, "label": int(label),
                           "leaves": self.kv.signature(), "nodes": nodes})
        path = self._cache_file(label)
        buf = io.BytesIO()
        np.savez(buf, meta=np.frombuffer(meta.encode("utf-8"), np.uint8),
                 **arrays)
        raw = buf.getvalue()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, path)
        with open(path[:-4] + ".crc", "w") as f:
            f.write(str(zlib.crc32(raw)))
        # trim cache files alongside the checkpointer's max_to_keep
        keep = {self._cache_file(st) for st in self._ckpt.all_steps()}
        for old in glob.glob(os.path.join(str(self.snapshot_dir),
                                          "cache_*.npz")):
            if old not in keep:
                for q in (old, old[:-4] + ".crc"):
                    try:
                        os.remove(q)
                    except FileNotFoundError:
                        pass
        if self.rec.enabled:
            self.rec.emit("snapshot.cache_save", cat="serve",
                          actor="engine",
                          payload={"label": int(label),
                                   "nodes": len(nodes),
                                   "bytes": len(raw)})
        return len(nodes)

    def _restore_cache_contents(self, label: int) -> int:
        """Warm-restore the cache file of snapshot ``label`` into the
        HOST tier: every node re-enters the trie as a spilled entry (no
        device block held) and is promoted by swap-in when a claim wants
        it. A missing file, a CRC mismatch, another pool's leaf signature
        or a truncated payload restores a cold cache instead (the
        continuations re-prefill; never a wrong token). Returns the
        number of nodes restored."""
        sd = self.sched
        path = self._cache_file(label)
        sig = self.kv.signature()
        try:
            with open(path, "rb") as f:
                raw = f.read()
            with open(path[:-4] + ".crc") as f:
                want = int(f.read().strip())
            if zlib.crc32(raw) != want:
                raise ValueError("cache file CRC mismatch")
            data = np.load(io.BytesIO(raw))
            meta = json.loads(bytes(data["meta"]).decode("utf-8"))
            if meta.get("version") != 1 or meta["leaves"] != sig:
                raise ValueError("cache file leaf signature mismatch")
            payloads = []
            for j in range(len(meta["nodes"])):
                payload = [np.asarray(data[f"n{j}_l{k}"])
                           for k in range(len(sig))]
                for a, rb, (shape, _) in zip(payload, self.kv.row_bytes,
                                             sig):
                    if list(a.shape) != shape or a.nbytes != rb:
                        raise ValueError(
                            "cache file node payload shape mismatch")
                payloads.append(payload)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            if self.rec.enabled:
                self.rec.emit("snapshot.cache_restore_miss", cat="serve",
                              actor="engine",
                              payload={"label": int(label),
                                       "error": str(e)})
            return 0
        restored = 0
        for nd, payload in zip(meta["nodes"], payloads):
            h = sd.store.put(CACHE_RID, payload)
            if h is None:
                break  # host tier full: keep what fits
            if sd.prefix.insert_spilled(nd["path"], h,
                                        adapter=int(nd["adapter"])):
                restored += 1
            else:
                sd.store.free(CACHE_RID, [h])
        if self.rec.enabled:
            self.rec.emit("snapshot.cache_restore", cat="serve",
                          actor="engine",
                          payload={"label": int(label),
                                   "nodes": restored})
        return restored

    def restore_latest_snapshot(self) -> int | None:
        """Restore the newest VALID snapshot (a truncated or CRC-corrupt
        one is skipped for the next older) into THIS engine, which must
        be fresh. The pool stays zeroed; every formerly-resident request
        re-enters as a queued continuation and re-prefills through the
        normal admission (and the captured steps), so each stream
        continues bitwise the uninterrupted run's. Returns the restored
        label, or None when no valid snapshot exists."""
        if self._ckpt is None:
            raise ValueError("ServeEngine(snapshot_dir=...) not configured")
        got = self._ckpt.restore_latest_valid(None)
        if got is None:
            if self.rec.enabled:
                self.rec.emit("snapshot.restore_miss", cat="serve",
                              actor="engine", payload={})
            return None
        tree, label = got
        state = json.loads(
            np.asarray(tree["blob"], np.uint8).tobytes().decode("utf-8"))
        self.sched.restore_state(state["sched"])
        if self.persist_cache:
            # warm the trie BEFORE the first admit, so every restored
            # continuation claims its cached prefix and re-prefills only
            # its suffix
            self._restore_cache_contents(label)
        self._tick = int(state["tick"])
        for k, v in state["steps"].items():
            self.steps[k] = int(v)
        self._last_snap = label
        if self.rec.enabled:
            self.rec.emit(
                "snapshot.restore", cat="serve", actor="engine",
                payload={"label": int(label),
                         "requests": len(state["sched"]["requests"])})
        return label

    def close(self) -> None:
        """Release background resources (watchdog thread, checkpointer)
        and drop the prefix cache's block references, device AND host
        tier, plus any banked spill records, so the scheduler's
        ``check_leaks()`` audits clean after shutdown."""
        self.sched.release_prefix_cache()
        if self.store is not None:
            self.sched.release_spill_store()
        if self._watchdog is not None:
            self._watchdog.close()
        if self._ckpt is not None:
            self._ckpt.close()
        # the device side goes too: the graphs, the pool and the staging
        # buffers (a fleet replaces a crashed replica's engine, and its
        # pool must not outlive it on the card); a step a caller swapped
        # in for its own has nothing of the engine's to release
        for step in (self.fns.decode, self.fns.prefill,
                     self.fns.decode_fn, self.fns.prefill_fn):
            if isinstance(step, _Step):
                step.release()
        self.pool = self.kv = None


def lint_contracts():
    """Contracts for the serving steps: the decode and prefill-chunk
    pair, and the decode variants (multi-LoRA, MoE, weight-only int8 and
    fp8, MoE with int8 banks), each the EAGER step
    (``fns.decode_fn`` / ``fns.prefill_fn``), which is the body the card's
    graphs capture.

    Collective-free (a stray psum would deadlock a replicated server),
    free of host syncs and global draws, the pool updated in place
    (``alias``: every pool leaf read, written, never copied, the same
    buffer after the step), and a ceiling on the largest f32 tensor that
    sits BELOW a full-``max_len`` f32 score tensor: the lint fails if
    anyone brings dense (slots, heads, chunk, max_len) scores back into
    the serve path (K6 reads the pool through its block tables)."""
    from distributed_tensorflow_guide_tpu_torch.analysis.contracts import (
        CostPin,
        CostSpec,
        DonationSpec,
        ProgramContract,
    )

    # fixture geometry: every legitimate f32 tensor (largest: one pool
    # leaf, num_blocks * heads * block * head_dim = 5 * 2 * 8 * 8 = 640,
    # or a widened kernel, at most 48 * 16 = 768) fits under the cap,
    # while dense f32 scores (decode: slots * heads * max_len = 2048;
    # prefill: heads * chunk * max_len = 4096) would not
    S, NB, BS, CH, MAXLEN = 4, 5, 8, 8, 256
    F32_CAP = 1024

    def _inputs(fns, cfg, kind):
        """The host arrays of one step: slots at their own lengths in
        their own blocks (slot 2 empty, its table all trash block 0)."""
        rng = np.random.RandomState(3)
        n_blk = fns.n_blk
        if kind == "prefill":
            tables = np.zeros((1, n_blk), np.int32)
            tables[0, :2] = (1, 2)
            arrays = [tables, np.array([4], np.int32),
                      rng.randint(0, cfg.vocab_size, (1, CH)),
                      np.array([CH - 2])]
            return arrays + ([np.array([1])] if fns.lora else [])
        tables = np.zeros((S, n_blk), np.int32)
        written = np.array([3, 7, 0, 5], np.int32)
        for i, blk in enumerate((1, 2, 0, 4)):
            tables[i, 0] = blk
        arrays = [tables, written, rng.randint(0, cfg.vocab_size, S)]
        return arrays + ([np.array([0, 1, 2, 1])] if fns.lora else [])

    def _build(kind):
        def _b(device):
            from distributed_tensorflow_guide_tpu_torch.analysis.fixtures import (  # noqa: E501
                tiny_lm,
                tiny_lm_cfg,
            )

            wq = ("int8" if kind in ("decode_wq8", "decode_moe_wq8")
                  else "fp8" if kind == "decode_wqfp8" else None)
            base = dataclasses.replace(
                tiny_lm_cfg(vocab_size=32, max_len=MAXLEN),
                **({"lora_rank": 2, "lora_adapters": 2}
                   if kind == "decode_lora" else {}),
                **({"moe_experts": 4, "moe_capacity": 2}
                   if "moe" in kind else {}))
            model = tiny_lm(base, device)
            cfg = base
            if wq is not None:
                model = model.quantize(wq)
                cfg = model.cfg
            fns = build_step_fns(cfg, slots=S, num_blocks=NB,
                                 block_size=BS, prefill_chunk=CH,
                                 device=device)
            view = model.with_config(fns.cfg)
            if fns.lora:
                rng = np.random.RandomState(4)
                view.set_adapter_bank({
                    name: (rng.standard_normal(shape) * 0.1).astype(
                        np.float32)
                    for name, (shape, _) in adapter_bank_shapes(
                        fns.cfg).items()})
            pool = paged_cache_pool(view)
            step = (fns.prefill_fn if kind.startswith("prefill")
                    else fns.decode_fn)
            return step, (view, pool,
                          *_inputs(fns, cfg, "prefill"
                                   if kind.startswith("prefill")
                                   else "decode"))

        return _b

    common = dict(
        policy="f32",
        collectives={},  # strict: the serve steps are collective-free
        max_f32_intermediate_elems=F32_CAP,
        donation=DonationSpec(argnums=(1,), mode="alias"),
        sources=("distributed_tensorflow_guide_tpu_torch.serve.engine",
                 "distributed_tensorflow_guide_tpu_torch.serve.paged_cache",
                 "distributed_tensorflow_guide_tpu_torch.models.transformer",
                 "distributed_tensorflow_guide_tpu_torch.ops."
                 "decode_attention"),
    )

    def _sibling_read(sibling) -> float:
        from distributed_tensorflow_guide_tpu_torch.analysis import lint

        rep = lint.lint_contract(sibling, "cpu")
        return next(r.observed["hbm_bytes_read"] for r in rep.rules
                    if r.rule == "cost")

    # every quantised kernel element of the fixture: per layer qkv
    # 16 * 48 + proj 16 * 16 + up 16 * 32 + down 32 * 16 = 2048, x 2
    # layers, plus lm_head 16 * 32 = 512 -> 4608; stored in one byte, each
    # is read by the product at 1 byte instead of the f32 sibling's 4.
    # Plus the MLP up projection's bias (32 f32 a layer, x 2): the f32
    # sibling's ``addmm`` reads it as a product operand, the quantised
    # projection adds it elementwise (fused, free)
    WQ8_SAVED_BYTES = 3 * 4608 + 2 * 32 * 4
    # the MoE fixture's: per layer qkv 768 + proj 256 + expert banks
    # w_in 4 * 16 * 32 + w_out 4 * 32 * 16 = 4096, x 2 layers, plus
    # lm_head 512 -> 10752 (the f32 router is exempt)
    MOE_WQ8_SAVED_BYTES = 3 * 10752

    sibling = ProgramContract(
        name="serve_decode_step",
        build=_build("decode"),
        # 50,960 observed on the CPU census
        cost=CostSpec(max_peak_live_bytes=57344),
        notes="fixed-slot paged decode: pool updated in place, no "
              "full-max_len f32 score tensor",
        **common)
    moe_sibling = ProgramContract(
        name="serve_decode_step_moe",
        build=_build("decode_moe"),
        # 75,796 observed on the CPU census
        cost=CostSpec(max_peak_live_bytes=81920),
        notes="MoE decode: router dispatch and fixed-capacity expert "
              "products inside the step; per-slot overflow flags drive "
              "the engine's stall-and-retry; idle slots masked out",
        **common)
    return [
        sibling,
        ProgramContract(
            name="serve_decode_step_wq8",
            build=_build("decode_wq8"),
            quantized_matmuls=True,
            cost=CostSpec(
                pins=(CostPin(
                    "hbm_bytes_read",
                    lambda: _sibling_read(sibling) - WQ8_SAVED_BYTES,
                    note="f32 decode read bytes minus 3 B x 4608 "
                         "quantised kernel elems and the up bias"),),
                # 40,880 observed on the CPU census
                max_peak_live_bytes=49152),
            notes="weight-only int8 decode: int8 kernels + f32 column "
                  "scales; the port widens the stored kernel into an f32 "
                  "copy at every call (wq_matmul) and the product reads "
                  "it at its 1-byte origin",
            **common),
        ProgramContract(
            name="serve_decode_step_wqfp8",
            build=_build("decode_wqfp8"),
            # NOT fp8_matmuls: only the kernel is widened from e4m3, the
            # activation is f32, so every product is an f32 product (the
            # weight-only discipline); the saved read bytes are int8's
            cost=CostSpec(
                pins=(CostPin(
                    "hbm_bytes_read",
                    lambda: _sibling_read(sibling) - WQ8_SAVED_BYTES,
                    note="f32 decode read bytes minus 3 B x 4608 "
                         "fp8-stored kernel elems and the up bias"),),
                # 40,880 observed on the CPU census
                max_peak_live_bytes=49152),
            notes="weight-only fp8 decode: e4m3 kernels + f32 column "
                  "scales, widened at every call like int8's",
            **common),
        ProgramContract(
            name="serve_prefill_chunk_step",
            build=_build("prefill"),
            # 51,272 observed on the CPU census
            cost=CostSpec(max_peak_live_bytes=57344),
            notes="B=1 chunked prefill through K6",
            **common),
        ProgramContract(
            name="serve_decode_step_lora",
            build=_build("decode_lora"),
            # 61,904 observed on the CPU census
            cost=CostSpec(max_peak_live_bytes=65536),
            notes="multi-adapter decode: gathered low-rank deltas stay "
                  "collective-free and under the f32 cap",
            **common),
        moe_sibling,
        ProgramContract(
            name="serve_decode_step_moe_wq8",
            build=_build("decode_moe_wq8"),
            quantized_matmuls=True,
            cost=CostSpec(
                pins=(CostPin(
                    "hbm_bytes_read",
                    lambda: _sibling_read(moe_sibling) - MOE_WQ8_SAVED_BYTES,
                    note="f32 MoE decode read bytes minus 3 B x 10752 "
                         "quantised kernel and bank elems"),),
                # 48,436 observed on the CPU census
                max_peak_live_bytes=57344),
            notes="weight-only int8 MoE decode: per-expert qkernel + scale "
                  "banks, one expert's kernel widened at a time "
                  "(wq_bank_matmul)",
            **common),
        ProgramContract(
            name="serve_prefill_chunk_step_moe",
            build=_build("prefill_moe"),
            # 81,708 observed on the CPU census
            cost=CostSpec(max_peak_live_bytes=90112),
            notes="B=1 MoE chunked prefill: dropless, pad rows masked out "
                  "of the census",
            **common),
    ]
