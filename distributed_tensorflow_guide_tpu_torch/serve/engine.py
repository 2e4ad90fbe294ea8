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

The host side (:class:`~.scheduler.Scheduler`, the block pool, the
prefix index) is the JAX package's, copied.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.core.dist import (
    retry_with_backoff,
)
from distributed_tensorflow_guide_tpu_torch.models.generation import (
    _sample,
    decode_config,
    fold_in,
    sample_rows,
)
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    table_row,
)
from distributed_tensorflow_guide_tpu_torch.serve.scheduler import (
    DECODE,
    PREFILL,
    EngineOverloaded,
    Request,
    Scheduler,
)

__all__ = ["Event", "Request", "ServeEngine", "EngineOverloaded",
           "build_step_fns", "paged_cache_pool", "paged_config"]

# ServeEngine knobs of the JAX engine that this package does not serve
# yet, and the ROADMAP item (Queue 1) that brings each
_DEFERRED = {
    "chaos": "item 11 (chaos and resilience)",
    "snapshot_dir": "item 11 (engine snapshots)",
    "host_blocks": "item 10 (host spill tier)",
    "persist_cache": "item 10 (warm cache persistence)",
    "adapters": "item 7 (multi-LoRA serving)",
    "step_deadline_s": "item 11 (watchdog)",
    "online_tune": "item 16 (autotune)",
}


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


def build_step_fns(cfg: TransformerConfig, *, num_blocks: int,
                   block_size: int, temperature: float = 0.0,
                   top_k: int | None = None) -> SimpleNamespace:
    """The two step functions, plain functions of (paged model view,
    pool, host-built tensors). Both update the pool in place."""
    pcfg = paged_config(cfg, num_blocks=num_blocks, block_size=block_size)

    @torch.inference_mode()
    def decode_step(model, pool, tables, written, last_tok, pos_keys):
        """(S,) tokens in, (S,) tokens out. ``pos_keys`` (S, 2): each
        slot's key of the position it samples, host-made (None when
        greedy)."""
        logits = model(last_tok[:, None], written, cache=pool,
                       block_tables=tables)
        return sample_rows(logits[:, -1], pos_keys, temperature, top_k)

    @torch.inference_mode()
    def prefill_chunk_step(model, pool, tables, start, chunk, valid: int,
                           pos_key):
        """One (1, prefill_chunk) slice of one prompt. ``valid`` rows are
        real prompt; the rest are pads whose writes land inside the
        request's blocks and are overwritten or masked forever. The sample
        comes from row ``valid - 1`` with ``pos_key``, the key of absolute
        position ``start + valid`` (host-made; None when greedy)."""
        logits = model(chunk, start, cache=pool, block_tables=tables)
        return _sample(logits[0, valid - 1][None], pos_key, temperature,
                       top_k)[0]

    return SimpleNamespace(decode=decode_step, prefill=prefill_chunk_step,
                           cfg=pcfg, n_blk=pcfg.max_len // block_size,
                           sampled=temperature != 0.0)


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
    asked for).
    """

    def __init__(self, cfg: TransformerConfig, model: Transformer, *,
                 slots: int, num_blocks: int, block_size: int,
                 prefill_chunk: int, temperature: float = 0.0,
                 top_k: int | None = None, max_queue: int | None = None,
                 retry_attempts: int = 3, retry_base_delay_s: float = 0.05,
                 prefix_cache: bool = False, tenant_quotas=None,
                 drr_quantum: int | None = None, recorder=None,
                 device=None, **deferred):
        for knob, value in deferred.items():
            if knob not in _DEFERRED:
                raise TypeError(f"unexpected keyword argument {knob!r}")
            if value not in (None, 0, False):
                raise NotImplementedError(
                    f"{knob} is not ported yet: ROADMAP Queue 1 "
                    f"{_DEFERRED[knob]}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.fns = build_step_fns(cfg, num_blocks=num_blocks,
                                  block_size=block_size,
                                  temperature=temperature, top_k=top_k)
        self.model = model.with_config(self.fns.cfg)
        self.num_slots = slots
        self.rec = recorder if recorder is not None else obs_events.current()
        self.sched = Scheduler(
            slots=slots, num_blocks=num_blocks, block_size=block_size,
            prefill_chunk=prefill_chunk, max_len=self.fns.cfg.max_len,
            max_queue=max_queue, prefix_cache=prefix_cache,
            tenant_quotas=tenant_quotas, drr_quantum=drr_quantum,
            recorder=self.rec)
        self.pool = paged_cache_pool(self.model)
        self._trash_row = table_row(
            [], self.fns.n_blk, self.sched.pool.trash_block)
        self.steps = {"decode": 0, "prefill": 0, "idle": 0}
        self.retry_attempts = retry_attempts
        self.retry_base_delay_s = retry_base_delay_s
        # every failed launch attempt (retried-and-recovered ones included)
        self.launch_failures = 0
        self._tick = 0
        self._ttft_ewma: float | None = None  # predicted-TTFT shed gate
        self.last_tick_s = 0.0

    # ---- intake ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size and int(prompt.max()) >= self.fns.cfg.vocab_size:
            raise ValueError("prompt token out of vocabulary")
        if req.adapter != 0:
            raise ValueError(
                f"request {req.rid} names adapter {req.adapter} but the "
                "engine serves no adapters")
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
            req, prompt=prompt, rng=np.asarray(req.rng, np.uint32)))
        if self.rec.enabled:
            self.rec.emit(
                "req.submit", cat="serve", actor="engine",
                payload={"rid": req.rid, "tenant": int(req.tenant),
                         "adapter": int(req.adapter),
                         "prompt_len": int(prompt.size),
                         "max_new": int(req.max_new_tokens)},
                t=float(req.arrival))

    def cancel(self, rid: int) -> bool:
        """Client abandon: free the stream's slot+blocks at the next step
        boundary. Returns False for unknown/already-terminal rids."""
        return self.sched.cancel(rid)

    # ---- the tick --------------------------------------------------------

    def step(self, now: float = 0.0) -> tuple[list[Event], str]:
        """One engine tick: sweep lifecycle (cancellations / deadlines),
        admit arrived requests, launch (at most) one step, apply its
        results. Returns (events, kind) with kind in {"prefill",
        "decode", "idle"}."""
        tick = self._tick
        self._tick += 1
        rec = self.rec
        if rec.enabled:
            self.sched.now = now  # timestamps scheduler decisions
        events = [Event(now, *t) for t in self.sched.sweep(now)]
        self.sched.admit(now)
        kind, arg = self.sched.plan()
        launch = None
        if rec.enabled and kind != "idle":
            # capture launch identity BEFORE the step runs: apply_* frees
            # a slot the moment its request completes
            if kind == PREFILL:
                s = self.sched.slots[arg]
                launch = {"slot": arg, "rid": s.rid,
                          "chunk": s.chunk_cursor}
            else:
                launch = {"slots": list(arg),
                          "rids": [self.sched.slots[i].rid for i in arg]}
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
        """One guarded step launch, retried through ``retry_with_backoff``:
        every launch input is rebuilt from host state and the sampling
        seeds are position-derived, so a retried launch re-runs the same
        tick bitwise."""

        def attempt():
            try:
                return fn()
            except Exception:
                self.launch_failures += 1
                raise

        return retry_with_backoff(
            attempt, attempts=self.retry_attempts,
            base_delay_s=self.retry_base_delay_s, max_delay_s=1.0,
            what=tag)

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _run_prefill(self, i: int, now: float) -> list[Event]:
        s = self.sched.slots[i]
        CH = self.sched.prefill_chunk
        start = s.chunk_cursor * CH
        valid = min(CH, len(s.prompt) - start)
        chunk = np.zeros((1, CH), np.int64)
        chunk[0, :valid] = s.prompt[start:start + valid]
        tables = table_row(s.blocks, self.fns.n_blk,
                           self.sched.pool.trash_block)[None]
        # the sample's key, folded on the host: greedy derives none
        pos_key = (fold_in(s.rng, start + valid) if self.fns.sampled
                   else None)
        args = (self.model, self.pool, self._tensor(tables),
                self._tensor([start]), self._tensor(chunk, torch.int64),
                valid, pos_key)
        tok = self._launch(lambda: self.fns.prefill(*args),
                           tag="serve_prefill_chunk_step")
        return [Event(now, *ev) for ev in
                self.sched.apply_prefill(i, int(tok))]

    def _run_decode(self, ready: list[int], now: float) -> list[Event]:
        S, n_blk = self.num_slots, self.fns.n_blk
        tables = np.tile(self._trash_row, (S, 1))
        written = np.zeros((S,), np.int32)
        last_tok = np.zeros((S,), np.int64)
        keys = np.zeros((S, 2), np.int64)
        for i in ready:
            s = self.sched.slots[i]
            tables[i] = table_row(s.blocks, n_blk,
                                  self.sched.pool.trash_block)
            written[i] = s.written
            last_tok[i] = s.pending
            keys[i] = s.rng
        pos_keys = (fold_in(keys, written.astype(np.int64) + 1)
                    if self.fns.sampled else None)
        args = (self.model, self.pool, self._tensor(tables),
                self._tensor(written), self._tensor(last_tok, torch.int64),
                pos_keys)
        nxt = self._launch(lambda: self.fns.decode(*args),
                           tag="serve_decode_step").tolist()
        events = []
        for i in ready:
            events.extend(Event(now, *ev) for ev in
                          self.sched.apply_decode(i, int(nxt[i])))
        return events

    # ---- drain -----------------------------------------------------------

    def run(self, max_ticks: int | None = None) -> list[Event]:
        """Drain all submitted work ignoring arrival times (tick clock)."""
        events: list[Event] = []
        ticks = 0
        while self.sched.has_queued or self.sched.has_resident:
            evs, kind = self.step(now=float("inf"))
            events.extend(evs)
            if kind == "idle":
                raise RuntimeError(
                    "engine deadlock: work queued but nothing schedulable")
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
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
            "tenants": {t: dict(c) for t, c in sorted(sd.tenants.items())},
            "last_tick_s": self.last_tick_s,
            "ticks": self._tick,
            "launch_failures": self.launch_failures,
        }

    def close(self) -> None:
        """Drop the prefix cache's block references, so the scheduler's
        ``check_leaks()`` audits clean after shutdown."""
        self.sched.release_prefix_cache()
