"""Request scheduler: continuous batching over a fixed-slot decode batch.

All of the *dynamic* serving state lives here, on the host, in plain
Python — which requests are resident, which physical blocks they own,
how far each one has written — so the device programs
(serve/engine.py) stay fully static: a decode step always runs all
``slots`` rows, a prefill step always runs one ``prefill_chunk``-token
chunk. The scheduler changes the POPULATION between steps (Orca's
iteration-level scheduling): a finished request frees its slot and
blocks at the step boundary, a queued prompt is admitted into any empty
slot mid-flight, and nothing retraces.

Decisions are deterministic functions of the submitted trace: FIFO
admission by arrival time, lowest-id slots and blocks first, preemption
evicts the MOST RECENTLY admitted victim (its re-queued continuation
carries the original prompt plus everything already emitted, and the
position-derived sampling keys of models/generation.py make the
regenerated stream bitwise the one it would have produced uninterrupted
— eviction is free of replay divergence by construction). The
scheduler-determinism test replays a seeded arrival trace twice and
pins identical event logs.

Request lifecycle (PR 11) also lives here: per-request TTFT/total
deadlines and client cancellation are applied by :meth:`Scheduler.sweep`
at step boundaries ONLY — a launched program is never torn down mid
-step, so the pool ledger stays leak-free (``check_leaks`` clean) by
construction.  Overload is refused at ``submit`` (queue-depth gate →
:class:`EngineOverloaded`, a retriable rejection) instead of degrading
resident streams.  :meth:`snapshot_state`/:meth:`restore_state`
serialize every live request as a *continuation* — the exact transform
``_preempt`` applies — which is why engine restore re-prefills and
still lands on the same streams bitwise.

Continuations (the ``continuations`` attribute): ``"prefill"`` (the JAX
package's) re-prefills the residency's prompt plus every token it
emitted, in chunks; ``"replay"`` re-prefills only the residency's prompt, with the
chunk boundaries it had, and feeds the emitted tokens back one decode
step at a time (``Request.replay``: the samples are discarded, the k/v
written), so every cache row is rebuilt by the kernel that first wrote
it. Both give the uninterrupted stream where the chunk and the decode
step give a row the same bits (the CPU's plain versions); on the card
the K6 chunk and split regimes sum in other orders, so only ``"replay"``
keeps a preempted or restored stream bitwise there. A scheduler starts
with ``"prefill"``; the engine, which knows its device, sets ``"replay"``
on the card, and on the CPU the schedule then equals the JAX package's
step for step.

Prefix sharing & tenancy (PR 12): with ``prefix_cache=True`` admission
consults the radix :class:`~.prefix_index.PrefixIndex` and CLAIMS the
longest cached prefix by ref-bump (``pool.share``) instead of
re-prefilling it — the claim is capped to a multiple of
``lcm(block_size, prefill_chunk)`` strictly below the prompt length, so
the suffix prefill starts chunk-aligned, at least one prompt token is
always recomputed (the final sample needs a live chunk), and every
subsequent write (suffix chunks, pads, decode) lands in privately
allocated blocks — shared blocks are never written, which is the whole
copy-on-write discipline.  When the pool runs dry, LRU leaf-first trie
eviction is tried BEFORE preemption.  Requests carry a ``tenant`` id:
admission becomes deficit-round-robin across the per-tenant queue heads
(exactly head-of-line FIFO when one tenant is present) under optional
per-tenant slot/block quotas, so one tenant's burst cannot starve
another.

Cache hierarchy (PR 16): with a host :class:`~.paged_cache.BlockStore`
and a ``cache_io`` d2h/h2d adapter attached, preemption and trie LRU
eviction become DEMOTIONS instead of destructions — the victim's written
blocks swap out to host RAM (COW-shared blocks spill once, deduplicated
through a device->host content map), a preempted request resumes by
swap-in at admission instead of re-prefilling, and queued spilled
continuations are prefetched back onto device BETWEEN ticks so the h2d
copies land ahead of the decode launches that consume them.  The swap
path never changes tokens: position-derived sampling keys already make a
re-prefilled continuation bitwise-identical to the uninterrupted stream,
and a swap-in restores the *same bytes* the re-prefill would recompute —
the hierarchy moves cost, not content.  All device<->host traffic is
counted (``spill_*`` counters) so the byte model in benchmarks/common.py
can reconcile it against the PCIe roofline.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    BlockPool,
    blocks_for,
)
from distributed_tensorflow_guide_tpu_torch.serve.prefix_index import (
    CACHE_RID,
    PrefixIndex,
)

PREFILL, DECODE = "prefill", "decode"


class EngineOverloaded(RuntimeError):
    """Admission refused under overload — RETRIABLE by contract: nothing
    about the request was recorded, so re-submitting the identical
    request later yields the identical stream. Shedding at the door is
    what keeps resident streams inside their SLOs instead of degrading
    everyone a little."""

    retriable = True


@dataclasses.dataclass
class Request:
    """One serving request. ``rng`` is the request's own PRNG key (raw
    (2,) uint32, what ``jax.random.PRNGKey`` returns) — sampling keys
    derive from (rng, absolute position), which is what makes the
    engine's per-request stream bitwise a one-shot
    ``make_generate_fn(...)​(params, prompt[None], rng)`` run.

    ``ttft_deadline_s``/``deadline_s`` are optional budgets measured
    from ``arrival``: breach terminates the request with status
    ``"expired"`` at the next step boundary (TTFT applies only until
    the first token; total always). ``None`` = no deadline."""

    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    rng: np.ndarray  # (2,) uint32
    arrival: float = 0.0
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None
    tenant: int = 0  # fair-share / quota accounting unit
    adapter: int = 0  # LoRA adapter id (0 = base model)
    # a continuation's emitted tokens, fed back through decode steps after
    # ``prompt`` is prefilled (``continuations="replay"``)
    replay: tuple = ()


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: np.ndarray  # current prompt (original + pre-preemption emits)
    budget: int  # tokens still to emit from THIS residency
    rng: np.ndarray
    blocks: list[int]
    phase: str = PREFILL
    chunk_cursor: int = 0  # next prefill chunk index
    written: int = 0  # cache positions written so far
    pending: int = 0  # last sampled token (k/v not yet written)
    emitted_here: int = 0  # tokens emitted during THIS residency
    admitted_seq: int = 0
    tenant: int = 0
    adapter: int = 0
    prefix_len: int = 0  # cache positions claimed from the prefix index
    max_blocks: int = 0  # worst-case footprint (quota commitment)
    replayed: tuple = ()  # the residency's replay tokens, all of them
    replay: list = dataclasses.field(default_factory=list)  # still to feed


class Scheduler:
    """Slots + pool + queue; the engine asks it what to run each tick."""

    def __init__(self, *, slots: int, num_blocks: int, block_size: int,
                 prefill_chunk: int, max_len: int,
                 max_queue: int | None = None,
                 prefix_cache: bool = False,
                 tenant_quotas: dict[int, dict] | None = None,
                 drr_quantum: int | None = None,
                 host_store=None, cache_io=None,
                 recorder=None) -> None:
        if max_len % prefill_chunk:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must divide max_len "
                f"{max_len} (pad writes must stay inside the table)")
        if max_len % block_size:
            raise ValueError(
                f"block_size {block_size} must divide max_len {max_len}")
        if drr_quantum is not None and drr_quantum < 1:
            raise ValueError(f"drr_quantum must be >= 1, got {drr_quantum}")
        # "prefill" or "replay" (module docstring): the engine sets it
        self.continuations = "prefill"
        self.slots: list[_Slot | None] = [None] * slots
        self.pool = BlockPool(num_blocks, block_size)
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.max_len = max_len
        self.blocks_per_seq = max_len // block_size
        self.queue: list[Request] = []  # FIFO; preemptions go to the front
        self.emitted: dict[int, list[int]] = {}  # rid -> all emitted tokens
        self.first_emit: dict[int, bool] = {}  # rid -> saw first token yet
        self.done: set[int] = set()
        self._seq = 0  # admission counter (preemption picks the youngest)
        self._prefer_prefill = True  # interleave chunked prefill w/ decode
        self.preemptions = 0
        # lifecycle (PR 11): terminal statuses, deadlines, overload gate
        self.max_queue = max_queue  # submit sheds past this queue depth
        self.meta: dict[int, tuple[float, float | None, float | None]] = {}
        self.finished: dict[int, str] = {}  # rid -> done|cancelled|expired
        self._cancel_pending: set[int] = set()
        self.shed = 0
        self.cancelled = 0
        self.expired = 0
        # prefix sharing & tenancy (PR 12)
        self.prefix: PrefixIndex | None = (
            PrefixIndex(block_size) if prefix_cache else None)
        # claim granularity: a claim must be BOTH block-aligned (whole
        # shared blocks) and chunk-aligned (the suffix prefill starts on
        # a chunk boundary), and strictly below the prompt length (the
        # final chunk's sample must come from a live program)
        self._claim_g = math.lcm(block_size, prefill_chunk)
        # tenant -> {"slots": int|None, "blocks": int|None}
        self.tenant_quotas = {int(t): dict(q) for t, q in
                              (tenant_quotas or {}).items()}
        # deficit-round-robin: quantum defaults to the worst-case request
        # footprint, which makes single-tenant admission EXACTLY the
        # legacy head-of-line FIFO (the deficit gate can never block)
        self.drr_quantum = (self.blocks_per_seq if drr_quantum is None
                            else int(drr_quantum))
        self._deficit: dict[int, int] = {}
        self.tenant_of: dict[int, int] = {}  # rid -> tenant
        self.tenants: dict[int, dict[str, int]] = {}
        self.prefix_hit_tokens = 0
        self.prefill_tokens_saved = 0
        self.prefix_evictions = 0
        # cache hierarchy (PR 16): host spill tier + d2h/h2d adapter.
        # Both None = hierarchy off, every code path below is byte-
        # identical to the pool-only scheduler (the determinism pins).
        if (host_store is None) != (cache_io is None):
            raise ValueError(
                "host_store and cache_io come as a pair (the store holds "
                "spilled payloads, the io adapter moves them)")
        self.store = host_store
        self.io = cache_io
        # device block id -> host block id with IDENTICAL content; an
        # entry exists only while the device block is live and immutable
        # (COW: shared full blocks are never written; the pool's
        # on_recycle hook drops the entry the moment a block could be
        # re-handed-out and rewritten).  This is what makes COW-shared
        # blocks spill ONCE: later demoters find the live host copy and
        # ref-bump it instead of copying again.
        self._dev_to_host: dict[int, int] = {}
        self.pool.on_recycle = (
            lambda b: self._dev_to_host.pop(b, None))
        # rid -> spill record for a demoted (preempted) request:
        # {"entries": [("host", h) | ("dev", d, h)], "written", "pending"}.
        # A ("dev", d, h) entry is PREFETCH-STAGED: the payload is back
        # in device block d but the host hold h is retained so staging
        # is revocable for free under pressure.
        self._spilled: dict[int, dict] = {}
        self._prefetch_clock = 0
        self.spill_out_blocks = 0
        self.spill_in_blocks = 0
        self.spill_d2h_bytes = 0
        self.spill_h2d_bytes = 0
        self.spill_prefetched_blocks = 0
        self.spill_resumes = 0
        self.swapin_tokens_saved = 0
        # fleet tier (PR 18): streams detached to / adopted from another
        # replica's scheduler.  A migrated-out request counts as
        # ``preempted`` for its tenant (migration IS the ``_preempt``
        # continuation transform, applied cross-replica); ``submitted``
        # is never re-counted on adoption — that is the conservation
        # contract the fleet's aggregated ``health()["tenants"]`` pins.
        self.migrated_out = 0
        self.migrated_in = 0
        # observability (PR 14): observe-only. The engine passes its
        # recorder so both sides share one event stream, and refreshes
        # ``now`` (the semantic clock) at the top of every tick.
        self.rec = (recorder if recorder is not None
                    else obs_events.current())
        self.now = 0.0

    def _tc(self, tenant: int) -> dict[str, int]:
        return self.tenants.setdefault(int(tenant), {
            "submitted": 0, "admitted": 0, "tokens": 0, "done": 0,
            "shed": 0, "cancelled": 0, "expired": 0, "preempted": 0})

    # ---- intake ----------------------------------------------------------

    def max_request_blocks(self, prompt_len: int, max_new: int) -> int:
        padded = -(-prompt_len // self.prefill_chunk) * self.prefill_chunk
        return blocks_for(max(padded, prompt_len + max_new),
                          self.block_size)

    def submit(self, req: Request) -> None:
        P = int(len(req.prompt))
        if P < 1:
            raise ValueError("empty prompt")
        if req.tenant < 0:
            raise ValueError(f"tenant must be >= 0, got {req.tenant}")
        if req.adapter < 0:
            raise ValueError(f"adapter must be >= 0, got {req.adapter}")
        if P + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {P} + max_new {req.max_new_tokens} exceeds "
                f"max_len {self.max_len}")
        need = self.max_request_blocks(P, req.max_new_tokens)
        if need > self.pool.capacity:
            raise ValueError(
                f"request {req.rid} can never fit: needs "
                f"{need} blocks, pool capacity {self.pool.capacity}")
        quota = self.tenant_quotas.get(int(req.tenant), {})
        if quota.get("blocks") is not None and need > quota["blocks"]:
            raise ValueError(
                f"request {req.rid} can never fit tenant {req.tenant}'s "
                f"block quota: needs {need}, quota {quota['blocks']}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed += 1
            self._tc(req.tenant)["shed"] += 1
            if self.rec.enabled:
                self.rec.emit(
                    "req.shed", cat="serve", actor="scheduler",
                    payload={"rid": req.rid, "reason": "queue_depth",
                             "tenant": int(req.tenant),
                             "queue_depth": len(self.queue)},
                    t=float(req.arrival))
            raise EngineOverloaded(
                f"request {req.rid} shed: queue depth {len(self.queue)} at "
                f"the max_queue={self.max_queue} gate — retry later "
                "(nothing was recorded; the retried stream is identical)")
        self.queue.append(req)
        self.emitted.setdefault(req.rid, [])
        self.first_emit.setdefault(req.rid, False)
        self.tenant_of.setdefault(req.rid, int(req.tenant))
        self._tc(req.tenant)["submitted"] += 1
        # the request's lifecycle clock: original arrival + deadlines.
        # Continuations re-enter via queue.insert (not submit), so this
        # records exactly once per rid and deadline checks always measure
        # from the ORIGINAL arrival, never a preemption re-queue.
        self.meta.setdefault(req.rid, (float(req.arrival),
                                       req.ttft_deadline_s, req.deadline_s))

    # ---- admission -------------------------------------------------------

    def admit(self, now: float) -> list[int]:
        """Deficit-round-robin admission over per-tenant queue heads.

        Each round visits every tenant with a queued head (in queue
        order — continuations at the front keep their priority), credits
        its deficit with ``drr_quantum`` blocks, and admits the head when
        the deficit covers the request's worst-case footprint, the
        tenant's quotas allow it, and the pool can supply the blocks
        (after claiming any cached prefix — see :meth:`_claim_blocks`).
        Rounds repeat while some candidate is blocked ONLY by its
        deficit; the call returns when a round admits nobody else.

        Within a tenant this is strict head-of-line FIFO (no reordering
        past the head), and with a single tenant and the default quantum
        (= ``blocks_per_seq`` >= any request's cost) the deficit gate
        never blocks — admission order, slot choice and block ids are
        EXACTLY the legacy FIFO loop's, which is what keeps every PR-10/11
        determinism pin intact."""
        admitted: list[int] = []
        while None in self.slots:
            progressed = False
            deficit_waiting = False
            for req, tenant in self._tenant_heads():
                if None not in self.slots:
                    break
                if req.arrival > now:
                    continue
                if not self._quota_allows(tenant, req):
                    continue
                cost = self.max_request_blocks(
                    len(req.prompt), len(req.replay) + req.max_new_tokens)
                self._deficit[tenant] = (self._deficit.get(tenant, 0)
                                         + self.drr_quantum)
                if self._deficit[tenant] < cost:
                    deficit_waiting = True
                    continue
                record = self._spilled.get(req.rid)
                if record is not None:
                    # demoted continuation: resume by swap-in — phase
                    # DECODE with the restored cache, zero re-prefill
                    blocks = self._swap_in_record(req.rid, record)
                    if blocks is None:
                        continue
                    prefix_len = 0
                else:
                    claim = self._claim_blocks(req)
                    if claim is None:
                        continue
                    blocks, prefix_len = claim
                # remove by IDENTITY: dataclass equality would compare
                # numpy prompt arrays elementwise
                self.queue.pop(next(
                    i for i, r in enumerate(self.queue) if r is req))
                s = self.slots.index(None)
                self.slots[s] = _Slot(
                    rid=req.rid, prompt=np.asarray(req.prompt, np.int32),
                    budget=req.max_new_tokens, rng=req.rng, blocks=blocks,
                    chunk_cursor=prefix_len // self.prefill_chunk,
                    written=prefix_len, admitted_seq=self._seq,
                    tenant=int(req.tenant), adapter=int(req.adapter),
                    prefix_len=prefix_len, max_blocks=cost,
                    replayed=tuple(req.replay), replay=list(req.replay))
                if record is not None:
                    del self._spilled[req.rid]
                    resumed = self.slots[s]
                    resumed.phase = DECODE
                    resumed.written = int(record["written"])
                    resumed.pending = int(record["pending"])
                    self.spill_resumes += 1
                    self.swapin_tokens_saved += int(record["written"])
                    if self.rec.enabled:
                        self.rec.emit(
                            "spill.resume", cat="serve",
                            actor="scheduler",
                            payload={"rid": req.rid, "slot": s,
                                     "written": int(record["written"])},
                            t=self.now)
                self._seq += 1
                self._deficit[tenant] -= cost
                self._tc(tenant)["admitted"] += 1
                if prefix_len:
                    self.prefix_hit_tokens += prefix_len
                    self.prefill_tokens_saved += prefix_len
                if self.rec.enabled:
                    payload = {"rid": req.rid, "slot": s,
                               "tenant": tenant,
                               "prefix_len": prefix_len,
                               "blocks": len(blocks)}
                    w = self.now - float(req.arrival)
                    if math.isfinite(w):
                        payload["queue_wait_s"] = max(0.0, w)
                    self.rec.emit("req.admit", cat="serve",
                                  actor="scheduler", payload=payload,
                                  t=self.now)
                    if prefix_len:
                        self.rec.emit("prefix.hit", cat="serve",
                                      actor="scheduler",
                                      payload={"rid": req.rid,
                                               "tokens": prefix_len},
                                      t=self.now)
                admitted.append(s)
                progressed = True
            if not progressed and not deficit_waiting:
                break
        # standard DRR reset: a tenant with nothing queued carries no credit
        queued_tenants = {int(r.tenant) for r in self.queue}
        for t in [t for t in self._deficit if t not in queued_tenants]:
            del self._deficit[t]
        return admitted

    def _tenant_heads(self) -> list[tuple[Request, int]]:
        """(head request, tenant) per tenant, in queue-front order — the
        deterministic round order (continuations at the front go first)."""
        heads: list[tuple[Request, int]] = []
        seen: set[int] = set()
        for req in self.queue:
            t = int(req.tenant)
            if t not in seen:
                seen.add(t)
                heads.append((req, t))
        return heads

    def _quota_allows(self, tenant: int, req: Request) -> bool:
        """Slot/block quota check against COMMITTED usage (worst-case
        footprints of residents), so a quota can never be overrun later
        by decode growth. A blocked tenant is SKIPPED for the round —
        never head-of-line blocking for other tenants."""
        quota = self.tenant_quotas.get(tenant)
        if not quota:
            return True
        mine = [s for s in self.slots
                if s is not None and s.tenant == tenant]
        if quota.get("slots") is not None and len(mine) >= quota["slots"]:
            return False
        if quota.get("blocks") is not None:
            committed = sum(s.max_blocks for s in mine)
            cost = self.max_request_blocks(len(req.prompt),
                                           req.max_new_tokens)
            if committed + cost > quota["blocks"]:
                return False
        return True

    # ---- cache hierarchy: demotion / swap-in / prefetch (PR 16) ----------

    def _payload_bytes(self, payload) -> int:
        return sum(int(a.nbytes) for a in payload)

    def _demote_block(self, rid: int, block: int) -> int | None:
        """Move holder ``rid``'s interest in device ``block`` to the host
        tier: returns a host block id holding ``block``'s content, or
        None (no state change) when the store is full.  Deduplicated —
        if a live host copy of this exact content already exists
        (``_dev_to_host``), it is ref-bumped instead of copied, so a
        COW-shared block spills once no matter how many holders demote
        it.  Does NOT drop the pool hold; the caller frees the device
        block after banking the returned host id."""
        return self._demote_blocks(rid, [block])[0]

    def _demote_blocks(self, rid: int, blocks: list[int]) -> list:
        """Batched :meth:`_demote_block`: one d2h gather dispatch per
        pool leaf for the subset that actually needs copying (dedup
        hits just ref-bump).  Mirrors :meth:`_swap_in_blocks` — per-op
        dispatch overhead dominates single-block transfers, so both
        directions of the swap path batch.  Returns a per-block list of
        host ids with None entries where the store filled up (those
        blocks are left untouched)."""
        dedup = []
        copy_blocks = []
        for b in blocks:
            h = self._dev_to_host.get(b)
            if h is None or self.store.refcount(h) == 0:
                h = None
                copy_blocks.append(b)
            dedup.append(h)
        d2h_many = getattr(self.io, "d2h_many", None)
        if d2h_many is not None and copy_blocks:
            payloads = dict(zip(copy_blocks, d2h_many(copy_blocks)))
        else:
            payloads = {b: self.io.d2h(b) for b in copy_blocks}
        out = []
        full = False
        for b, h in zip(blocks, dedup):
            if h is not None:
                self.store.share(rid, [h])
            elif full:
                out.append(None)
                continue
            else:
                p = payloads[b]
                h = self.store.put(rid, p)
                if h is None:
                    full = True
                    out.append(None)
                    continue
                self._dev_to_host[b] = h
                self.spill_d2h_bytes += self._payload_bytes(p)
            self.spill_out_blocks += 1
            out.append(h)
        return out

    def _swap_in_block(self, rid: int, dst: int, host: int) -> None:
        """h2d one host block into device block ``dst`` (already
        allocated to ``rid``); the host hold is NOT dropped here."""
        self._swap_in_blocks(rid, [(dst, host)])

    def _swap_in_blocks(self, rid: int,
                        pairs: list[tuple[int, int]]) -> None:
        """h2d a batch of host blocks into already-allocated device
        blocks — one dispatch per pool leaf when the io adapter offers
        ``h2d_many``.  The eager scatter's per-op dispatch overhead is
        the swap path's dominant cost and it amortizes across the
        batch, so every multi-block swap-in (record resume, prefetch,
        multi-node claim promotion) routes through here.  Host holds
        are NOT dropped here."""
        if not pairs:
            return
        payloads = [self.store.get(h) for _, h in pairs]
        h2d_many = getattr(self.io, "h2d_many", None)
        if h2d_many is not None:
            h2d_many([d for d, _ in pairs], payloads)
        else:
            for (d, _), p in zip(pairs, payloads):
                self.io.h2d(d, p)
        self.spill_in_blocks += len(pairs)
        self.spill_h2d_bytes += sum(
            self._payload_bytes(p) for p in payloads)

    def _reclaim_one(self, reason: str) -> bool:
        """Free one device block, cheapest-first: revoke a prefetch-staged
        block (free — the host copy was retained), demote the coldest
        trie block to host (one d2h copy, trie structure preserved), and
        only then the destructive LRU leaf eviction.  With the hierarchy
        off this is EXACTLY the legacy behavior: only the destructive
        branch exists."""
        if self.store is not None and self._revoke_prefetch():
            return True
        if self.prefix is not None and self.store is not None:
            freed = self.prefix.demote_many(
                self.pool, self._cache_demote_batch, limit=8)
            if freed:
                if self.rec.enabled:
                    self.rec.emit("spill.demote", cat="serve",
                                  actor="scheduler",
                                  payload={"blocks": freed,
                                           "reason": reason}, t=self.now)
                return True
        if (self.prefix is not None
                and self.prefix.evict_one(self.pool) is not None):
            self.prefix_evictions += 1
            if self.rec.enabled:
                self.rec.emit("prefix.evict", cat="serve",
                              actor="scheduler",
                              payload={"reason": reason}, t=self.now)
            return True
        return False

    def _cache_demote(self, block: int) -> int | None:
        """The trie's demote callable: spill for CACHE_RID and drop the
        cache's pool hold on success."""
        h = self._demote_block(CACHE_RID, block)
        if h is not None:
            self.pool.free(CACHE_RID, [block])
        return h

    def _cache_demote_batch(self, blocks: list[int]) -> list:
        """Batch form of :meth:`_cache_demote` for the trie's
        :meth:`~.prefix_index.PrefixIndex.demote_many`."""
        hs = self._demote_blocks(CACHE_RID, blocks)
        self.pool.free(CACHE_RID,
                       [b for b, h in zip(blocks, hs) if h is not None])
        return hs

    def _promote_nodes(self, nodes) -> list[int] | None:
        """Swap a batch of spilled trie nodes' payloads back onto device
        (one h2d dispatch per pool leaf) so a claim can ref-bump them.
        Returns the new device block ids in node order, or None when the
        blocks cannot be found even after reclaim (the claim falls back
        to re-prefill).  Safe against self-reclaim: the claim shares
        every device-resident node of its chain BEFORE promoting, so
        reclaim can neither demote nor evict a block the claim stands
        on, and spilled nodes are untouchable by either ladder rung."""
        got = self.pool.alloc(CACHE_RID, len(nodes))
        while got is None and self._reclaim_one("promote"):
            got = self.pool.alloc(CACHE_RID, len(nodes))
        if got is None:
            return None
        self._swap_in_blocks(
            CACHE_RID, [(d, n.host) for d, n in zip(got, nodes)])
        for d, node in zip(got, nodes):
            h = node.host
            self.store.free(CACHE_RID, [h])
            if self.store.refcount(h) > 0:
                self._dev_to_host[d] = h
            node.block = d
            node.host = None
        return got

    def _demote_slot(self, slot: _Slot) -> bool:
        """Preemption as demotion: spill the victim's WRITTEN blocks to
        host and bank a spill record so admission resumes it by swap-in
        (phase DECODE, zero re-prefill) instead of re-prefilling.
        Only decode-phase victims qualify — a mid-prefill victim has
        cheap state to rebuild and its partial chunks are not all
        block-aligned.  Returns False (caller frees destructively) when
        the hierarchy is off or the store cannot take the copies."""
        if (self.store is None or slot.phase != DECODE or slot.written < 1
                or slot.replay):
            return False
        n_keep = blocks_for(slot.written, self.block_size)
        keep = slot.blocks[:n_keep]
        if self.store.capacity is not None:
            new_copies = sum(
                1 for b in keep
                if (h := self._dev_to_host.get(b)) is None
                or self.store.refcount(h) == 0)
            if (self.store.live_blocks() + new_copies
                    > self.store.capacity):
                return False
        hs = self._demote_blocks(slot.rid, keep)
        if any(h is None for h in hs):
            # bounded store pre-checked above — defensive
            self.store.free(slot.rid, [h for h in hs if h is not None])
            return False
        entries: list[tuple] = [("host", h) for h in hs]
        self.pool.free(slot.rid, slot.blocks)
        self._spilled[slot.rid] = {
            "entries": entries,
            "written": int(slot.written),
            "pending": int(slot.pending),
        }
        if self.rec.enabled:
            self.rec.emit("spill.out", cat="serve", actor="scheduler",
                          payload={"rid": slot.rid, "blocks": n_keep,
                                   "written": int(slot.written)},
                          t=self.now)
        return True

    def _swap_in_record(self, rid: int, record: dict) -> list[int] | None:
        """Materialize a spill record's blocks on device for admission.
        Staged entries already own their device block (drop the retained
        host hold); unstaged entries h2d into freshly allocated blocks.
        All-or-nothing: on allocation failure nothing changes and the
        record stays banked for a later tick."""
        entries = record["entries"]
        # recompute `need` after every reclaim: a reclaim can revoke a
        # staged entry of THIS record (it is still queued), flipping a
        # ("dev", ...) entry back to ("host", ...)
        while True:
            need = sum(1 for e in entries if e[0] == "host")
            fresh = self.pool.alloc(rid, need)
            if fresh is not None:
                break
            if not self._reclaim_one("swap_in"):
                return None
        blocks: list[int] = []
        hosts: list[int] = []
        fi = 0
        bs = self.block_size
        for e in entries:
            if e[0] == "dev":
                blocks.append(e[1])
                hosts.append(e[2])
            else:
                blocks.append(fresh[fi])
                hosts.append(e[1])
                fi += 1
        self._swap_in_blocks(rid, [
            (blocks[j], hosts[j]) for j, e in enumerate(entries)
            if e[0] == "host"])
        for j, (d, h) in enumerate(zip(blocks, hosts)):
            self.store.free(rid, [h])
            # bank the content association only for FULL immutable
            # blocks — the partial tail block is rewritten by decode
            if ((j + 1) * bs <= record["written"]
                    and self.store.refcount(h) > 0):
                self._dev_to_host[d] = h
        return blocks

    def prefetch(self) -> int:
        """Stage queued spilled continuations' host blocks back onto
        device AHEAD of admission (the engine calls this between sweep
        and admit every tick), so the h2d copies overlap decode launches
        instead of serializing with the resume.  Greedy in queue order,
        but never below a growth reserve of one free block per resident
        slot — staging must not starve decode growth into preempting
        somebody.  Staged blocks keep their host hold (revocable for
        free).  Returns the number of blocks staged."""
        if self.store is None or not self._spilled:
            return 0
        self._prefetch_clock += 1
        staged = 0
        resident = sum(1 for s in self.slots if s is not None)
        for req in self.queue:
            record = self._spilled.get(req.rid)
            if record is None:
                continue
            # a recently revoked record sits out a few ticks — without
            # the cooldown a tight pool thrashes stage -> revoke ->
            # re-stage, paying a real h2d copy each lap
            if record.get("cool_until", 0) > self._prefetch_clock:
                continue
            todo = [(j, e[1])
                    for j, e in enumerate(record["entries"])
                    if e[0] == "host"]
            if not todo:
                continue
            if self.pool.free_blocks - len(todo) < resident:
                continue  # not enough headroom for the WHOLE record
            got = self.pool.alloc(req.rid, len(todo))
            if got is None:
                return staged
            self._swap_in_blocks(req.rid, [
                (d, h) for d, (_, h) in zip(got, todo)])
            for d, (j, h) in zip(got, todo):
                record["entries"][j] = ("dev", d, h)
                if ((j + 1) * self.block_size <= record["written"]
                        and self.store.refcount(h) > 0):
                    self._dev_to_host[d] = h
                self.spill_prefetched_blocks += 1
                staged += 1
        if staged and self.rec.enabled:
            self.rec.emit("spill.prefetch", cat="serve",
                          actor="scheduler",
                          payload={"blocks": staged}, t=self.now)
        return staged

    def _revoke_prefetch(self) -> bool:
        """Un-stage ONE prefetched block to relieve pool pressure — the
        host hold was retained, so this frees a device block without
        losing anything.  Deepest-queued record, last entry first (the
        work farthest from being needed)."""
        for req in reversed(self.queue):
            record = self._spilled.get(req.rid)
            if record is None:
                continue
            for j in range(len(record["entries"]) - 1, -1, -1):
                e = record["entries"][j]
                if e[0] == "dev":
                    _, d, h = e
                    self.pool.free(req.rid, [d])
                    record["entries"][j] = ("host", h)
                    record["cool_until"] = self._prefetch_clock + 8
                    return True
        return False

    def _drop_spill_record(self, rid: int) -> None:
        """Release every hold a spill record owns (terminal sweep of a
        queued spilled continuation, or engine shutdown)."""
        record = self._spilled.pop(rid, None)
        if record is None:
            return
        for e in record["entries"]:
            if e[0] == "dev":
                _, d, h = e
                self.pool.free(rid, [d])
                self.store.free(rid, [h])
            else:
                self.store.free(rid, [e[1]])

    def release_spill_store(self) -> int:
        """Drop every spill record (engine close).  Trie host holds are
        released by :meth:`release_prefix_cache`.  Returns the number of
        records dropped."""
        rids = list(self._spilled)
        for rid in rids:
            self._drop_spill_record(rid)
        return len(rids)

    def check_leaks(self) -> None:
        """Joint device+host ledger audit: the pool and store invariants,
        plus the cross-tier ones — every spill-record entry holds what it
        claims on both tiers, every spilled trie node's host block is
        held for the cache, and the dedup map only keys live device
        blocks."""
        self.pool.check_leaks()
        if self.store is None:
            return
        self.store.check_leaks()
        for rid, record in self._spilled.items():
            host_owned = set(self.store.owned_by(rid))
            dev_owned = set(self.pool.owned_by(rid))
            for e in record["entries"]:
                h = e[2] if e[0] == "dev" else e[1]
                if h not in host_owned:
                    raise AssertionError(
                        f"spill record {rid}: host block {h} not held")
                if e[0] == "dev" and e[1] not in dev_owned:
                    raise AssertionError(
                        f"spill record {rid}: staged device block "
                        f"{e[1]} not held")
        if self.prefix is not None:
            cache_host = set(self.store.owned_by(CACHE_RID))
            for _, _, node in self.prefix.walk():
                if node.block is None and node.host not in cache_host:
                    raise AssertionError(
                        f"spilled trie node host block {node.host} "
                        "not held for CACHE_RID")
        for d in self._dev_to_host:
            if self.pool.refcount(d) == 0:
                raise AssertionError(
                    f"dedup map keys recycled device block {d}")

    def _claim_blocks(self, req: Request) -> tuple[list[int], int] | None:
        """The request's admission blocks: cached-prefix blocks claimed by
        ref-bump first (prefix cache on), then fresh blocks for the rest
        of the padded prompt footprint — trying LRU leaf eviction before
        giving up when the pool is dry.  Returns ``(blocks, prefix_len)``
        or None (no state change) when the blocks cannot be found.  The
        claim is ref-bumped BEFORE the fresh alloc so eviction can never
        free a block the claim is standing on."""
        P = len(req.prompt)
        padded = -(-P // self.prefill_chunk) * self.prefill_chunk
        need = blocks_for(padded, self.block_size)
        shared: list[int] = []
        prefix_len = 0
        if self.prefix is not None:
            if self.store is not None:
                # hierarchy on: the match may include SPILLED nodes —
                # promote them by swap-in so the claim still saves their
                # prefill.  Two passes: first ref-bump every device-
                # resident node of the chain (so reclaim during the
                # promotion allocs can never free a block the claim
                # stands on), then promote ALL spilled nodes in one
                # batched h2d.  On a promotion failure (pool dry even
                # after reclaim) drop the whole claim and fall back to
                # a plain alloc — a shorter claim could misalign the
                # suffix chunk start.
                hit_nodes = self.prefix.match_nodes(
                    req.prompt, adapter=int(req.adapter))
                cap = ((P - 1) // self._claim_g) * self._claim_g
                prefix_len = min(len(hit_nodes) * self.block_size, cap)
                use = hit_nodes[:prefix_len // self.block_size]
                spilled = [n for n in use if n.block is None]
                failed = any(n.host is None for n in spilled)
                if not failed:
                    for n in use:
                        if n.block is not None:
                            self.pool.share(req.rid, [n.block])
                            shared.append(n.block)
                    if spilled:
                        promoted = self._promote_nodes(spilled)
                        if promoted is None:
                            failed = True
                        else:
                            self.pool.share(req.rid, promoted)
                            shared = [n.block for n in use]
                            self.swapin_tokens_saved += (
                                len(spilled) * self.block_size)
                if failed:
                    if shared:
                        self.pool.free(req.rid, shared)
                    shared = []
                    prefix_len = 0
            else:
                hit = self.prefix.match(req.prompt,
                                        adapter=int(req.adapter))
                cap = ((P - 1) // self._claim_g) * self._claim_g
                prefix_len = min(len(hit) * self.block_size, cap)
                shared = hit[:prefix_len // self.block_size]
                if shared:
                    self.pool.share(req.rid, shared)
        fresh = self.pool.alloc(req.rid, need - len(shared))
        while fresh is None and self._reclaim_one("admit"):
            fresh = self.pool.alloc(req.rid, need - len(shared))
        if fresh is None:
            if shared:
                self.pool.free(req.rid, shared)
            return None
        return shared + fresh, prefix_len

    # ---- tick planning ---------------------------------------------------

    def plan(self) -> tuple[str, object]:
        """What the engine should launch this tick: ``("prefill", slot)``
        one chunk for the oldest mid-prefill slot, ``("decode", [slots])``
        one decode step over the active population, or ``("idle", None)``.
        When both phases have work they ALTERNATE (chunked prefill
        interleaved with decode — a long prompt no longer stalls every
        resident stream for its whole prefill)."""
        prefills = [i for i, s in enumerate(self.slots)
                    if s is not None and s.phase == PREFILL]
        decodes = [i for i, s in enumerate(self.slots)
                   if s is not None and s.phase == DECODE]
        if prefills and (self._prefer_prefill or not decodes):
            self._prefer_prefill = False
            best = min(prefills,
                       key=lambda i: self.slots[i].admitted_seq)
            return (PREFILL, best)
        if decodes:
            self._prefer_prefill = bool(prefills)
            ready = self._grow_for_decode(decodes)
            if ready:
                return (DECODE, ready)
            prefills = [i for i, s in enumerate(self.slots)
                        if s is not None and s.phase == PREFILL]
            if prefills:
                best = min(prefills,
                           key=lambda i: self.slots[i].admitted_seq)
                return (PREFILL, best)
        return ("idle", None)

    def _grow_for_decode(self, decodes: list[int]) -> list[int]:
        """Every decoding slot must own the block its next write lands in;
        grow by one block where needed. When the pool is dry the prefix
        cache (if on) gives up LRU leaves FIRST — dropping cold cached
        suffixes nobody holds — and only then is the youngest other
        resident preempted (the prefix-off behavior, unchanged)."""
        ready = []
        for i in list(decodes):
            slot = self.slots[i]
            if slot is None:  # preempted by an earlier growth this tick
                continue
            while len(slot.blocks) * self.block_size < slot.written + 1:
                got = self.pool.alloc(slot.rid, 1)
                if got is not None:
                    slot.blocks.extend(got)
                    continue
                if self._reclaim_one("decode_grow"):
                    continue
                victim = self._pick_victim(exclude=i)
                if victim is None:
                    break  # stalled: no blocks, nothing to preempt
                self._preempt(victim)
            else:
                ready.append(i)
        return [i for i in ready if self.slots[i] is not None]

    def _pick_victim(self, exclude: int) -> int | None:
        """Deterministic victim choice, pinned by the _pick_victim test:
        the YOUNGEST resident by admission order (highest
        ``admitted_seq``) is evicted first — the request that has
        received the least service loses its residency, which bounds
        re-prefill waste and can never starve the head-of-line request.
        ``admitted_seq`` is unique (one counter, bumped per admission),
        so the max is total and two seeded runs can never diverge here —
        this ordering is also the restore path's anchor:
        ``snapshot_state`` writes residents in admission order."""
        live = [(s.admitted_seq, i) for i, s in enumerate(self.slots)
                if s is not None and i != exclude and s.blocks]
        if not live:
            return None
        return max(live)[1]  # youngest admission goes first

    def _preempt(self, i: int) -> None:
        slot = self.slots[i]
        # hierarchy on: demote the written blocks to host instead of
        # destroying them — the continuation below still queues, but
        # admission resumes it by swap-in with zero re-prefill
        spilled = self._demote_slot(slot)
        if not spilled:
            self.pool.free(slot.rid, slot.blocks)
        # continuation request: this residency's prompt plus every token
        # it emitted; budget = whatever is still owed. Position-derived
        # sampling keys make the re-run emit exactly the tokens it would
        # have produced uninterrupted, so preemption never forks the
        # stream. Goes to the FRONT of the queue (it was already served).
        cont_prompt, replay = self._continuation(slot)
        self.queue.insert(0, Request(
            rid=slot.rid, prompt=cont_prompt,
            max_new_tokens=slot.budget, rng=slot.rng,
            arrival=float("-inf"),
            tenant=slot.tenant, adapter=slot.adapter, replay=replay))
        self.slots[i] = None
        self.preemptions += 1
        self._tc(slot.tenant)["preempted"] += 1
        if self.rec.enabled:
            self.rec.emit("req.preempt", cat="serve", actor="scheduler",
                          payload={"rid": slot.rid, "slot": i,
                                   "emitted": slot.emitted_here,
                                   "spilled": spilled,
                                   "tenant": slot.tenant}, t=self.now)

    def _continuation(self, slot: _Slot, mode: str | None = None
                      ) -> tuple[np.ndarray, tuple]:
        """A resident's continuation as (prompt, replay): its residency's
        prompt and every token it fed or emitted since, either all to
        prefill (``"prefill"``) or the tokens to feed back through decode
        steps (``"replay"``)."""
        tail = list(slot.replayed)
        if slot.emitted_here:
            tail += self.emitted[slot.rid][-slot.emitted_here:]
        if (mode or self.continuations) == "replay":
            return slot.prompt, tuple(int(t) for t in tail)
        if not tail:
            return slot.prompt, ()
        return np.concatenate([slot.prompt, np.asarray(tail, np.int32)]), ()

    # ---- fleet tier: stream migration (PR 18) ----------------------------

    def migratable_blocks(self, rid: int) -> list[int]:
        """Device blocks whose contents must travel for ``rid`` to resume
        by swap-in on another replica: the WRITTEN blocks of a resident
        decode-phase slot, in position order.  Empty for mid-prefill
        residents and queued requests — their continuation re-prefills
        at the target, which lands on the same stream bitwise anyway
        (position-derived sampling keys)."""
        for s in self.slots:
            if s is not None and s.rid == rid:
                if s.phase != DECODE or s.written < 1:
                    return []
                return list(s.blocks[:blocks_for(s.written,
                                                 self.block_size)])
        return []

    def detach_stream(self, rid: int) -> dict:
        """Detach a live request into a portable migration record — the
        ``_preempt`` continuation transform, except the continuation
        leaves this scheduler entirely instead of re-queueing here.
        Every local hold is released (pool blocks; a queued spilled
        continuation drops its spill record — the target re-prefills);
        the record carries everything :meth:`attach_stream` needs to
        continue the stream bitwise elsewhere.  Emitted tokens and
        lifecycle meta TRAVEL with the stream (popped here, installed
        there), so fleet-aggregated per-tenant counters stay a disjoint
        sum: ``submitted`` counted once at the source, the terminal
        status once at wherever the stream finishes.  KV payloads do NOT
        travel here — the engine d2h-copies :meth:`migratable_blocks`
        BEFORE calling this and attaches them to the returned record.
        Raises KeyError for unknown or terminal rids."""
        if rid in self.finished:
            raise KeyError(
                f"rid {rid} is terminal ({self.finished[rid]}); "
                "only live streams migrate")
        record: dict | None = None
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                cont_prompt, _ = self._continuation(s, "prefill")
                self.pool.free(rid, s.blocks)
                self.slots[i] = None
                # migration IS preemption from this tenant's viewpoint:
                # the residency ended before the budget was spent
                self._tc(s.tenant)["preempted"] += 1
                record = {
                    "rid": rid, "prompt": cont_prompt,
                    "budget": int(s.budget), "rng": s.rng,
                    "arrival": float("-inf"),  # already served once
                    "tenant": int(s.tenant), "adapter": int(s.adapter),
                    "written": int(s.written) if s.phase == DECODE else 0,
                    "pending": int(s.pending) if s.phase == DECODE else 0,
                }
                break
        if record is None:
            for j, r in enumerate(self.queue):
                if r.rid == rid:
                    if self.store is not None:
                        self._drop_spill_record(rid)
                    self.queue.pop(j)
                    record = {
                        "rid": rid,
                        "prompt": np.concatenate([
                            np.asarray(r.prompt, np.int32),
                            np.asarray(r.replay, np.int32)]),
                        "budget": int(r.max_new_tokens), "rng": r.rng,
                        "arrival": float(r.arrival),
                        "tenant": int(r.tenant),
                        "adapter": int(r.adapter),
                        "written": 0, "pending": 0,
                    }
                    break
        if record is None:
            raise KeyError(f"rid {rid} not live on this scheduler")
        record["emitted"] = list(self.emitted.pop(rid, []))
        record["first_emit"] = bool(self.first_emit.pop(rid, False))
        m = self.meta.pop(rid, None)
        record["meta"] = None if m is None else [m[0], m[1], m[2]]
        self.tenant_of.pop(rid, None)
        record["payloads"] = []
        record["payload_bytes"] = 0
        self.migrated_out += 1
        if self.rec.enabled:
            self.rec.emit("req.migrate_out", cat="serve",
                          actor="scheduler",
                          payload={"rid": rid,
                                   "written": int(record["written"]),
                                   "tenant": int(record["tenant"])},
                          t=self.now)
        return record

    @staticmethod
    def continuation_record(*, rid: int, prompt, budget: int, rng,
                            emitted=(), tenant: int = 0, adapter: int = 0,
                            first_emit: bool | None = None,
                            meta=None,
                            arrival: float = float("-inf")) -> dict:
        """Build an :meth:`attach_stream`-compatible record WITHOUT a
        source scheduler — the supervisor-side continuation transform
        for a replica that died with no orderly :meth:`detach_stream`.
        ``prompt`` must already be the continuation prompt (the base
        prompt at dispatch plus every token observed since), ``budget``
        the remaining token budget, and ``emitted`` the stream's FULL
        emitted history (it travels with the record so fleet-merged
        completions stay a disjoint sum).  KV never survives a hard
        crash, so the record carries no payloads: the adopter
        re-prefills, which position-derived sampling keys make bitwise
        identical to the uninterrupted stream."""
        if budget < 1:
            raise ValueError(
                f"rid {rid}: a continuation needs budget >= 1, got "
                f"{budget} (an exhausted stream is terminal, not live)")
        emitted = [int(t) for t in emitted]
        return {
            "rid": int(rid),
            "prompt": np.asarray(prompt, np.int32).reshape(-1),
            "budget": int(budget),
            "rng": np.asarray(rng, np.uint32),
            "arrival": float(arrival),
            "tenant": int(tenant), "adapter": int(adapter),
            "written": 0, "pending": 0,
            "emitted": emitted,
            "first_emit": (bool(emitted) if first_emit is None
                           else bool(first_emit)),
            "meta": None if meta is None else [meta[0], meta[1], meta[2]],
            "payloads": [], "payload_bytes": 0,
        }

    def attach_stream(self, record: dict) -> None:
        """Adopt a migrated stream: install its identity maps and queue
        the continuation at the FRONT (it was already served elsewhere).
        KV payloads (if any) are banked into the host spill store as a
        spill record, so admission resumes the stream by swap-in — the
        same bytes the source replica wrote, which is why the continued
        stream is bitwise the uninterrupted one.  All-or-nothing: a full
        store rolls back every put and raises RuntimeError with no state
        change.  Deliberately bypasses :meth:`submit` — ``submitted``
        was counted at the source and must never recount here (the
        fleet-aggregation conservation pin)."""
        rid = int(record["rid"])
        if (rid in self.finished
                or any(s is not None and s.rid == rid
                       for s in self.slots)
                or any(r.rid == rid for r in self.queue)):
            raise ValueError(
                f"rid {rid} already live or terminal on this scheduler")
        payloads = record.get("payloads") or []
        if payloads:
            if self.store is None:
                raise RuntimeError(
                    "adopting KV payloads needs a host spill store "
                    "(attach landing pad); re-export without KV to "
                    "re-prefill instead")
            hs: list[int] = []
            for p in payloads:
                h = self.store.put(rid, p)
                if h is None:
                    self.store.free(rid, hs)
                    raise RuntimeError(
                        f"host store full adopting rid {rid} "
                        f"({len(payloads)} KV blocks)")
                hs.append(h)
            self._spilled[rid] = {
                "entries": [("host", h) for h in hs],
                "written": int(record["written"]),
                "pending": int(record["pending"]),
            }
        self.emitted[rid] = list(record.get("emitted", []))
        self.first_emit[rid] = bool(record.get("first_emit", False))
        self.tenant_of[rid] = int(record.get("tenant", 0))
        m = record.get("meta")
        if m is not None:
            self.meta[rid] = (
                float(m[0]),
                None if m[1] is None else float(m[1]),
                None if m[2] is None else float(m[2]))
        self.queue.insert(0, Request(
            rid=rid, prompt=np.asarray(record["prompt"], np.int32),
            max_new_tokens=int(record["budget"]),
            rng=np.asarray(record["rng"], np.uint32),
            arrival=float(record.get("arrival", float("-inf"))),
            tenant=int(record.get("tenant", 0)),
            adapter=int(record.get("adapter", 0))))
        self.migrated_in += 1
        if self.rec.enabled:
            self.rec.emit("req.migrate_in", cat="serve",
                          actor="scheduler",
                          payload={"rid": rid,
                                   "kv_blocks": len(payloads),
                                   "written": int(record["written"]),
                                   "tenant": int(record["tenant"])},
                          t=self.now)

    # ---- result application ---------------------------------------------

    def prefill_done_chunks(self, slot_idx: int) -> int:
        s = self.slots[slot_idx]
        return -(-len(s.prompt) // self.prefill_chunk)

    def apply_prefill(self, slot_idx: int, token: int) -> list[tuple]:
        """One chunk finished for ``slot_idx``; ``token`` is the program's
        sample from the chunk's last valid row (meaningful only on the
        final chunk). Returns [(rid, token, first, done)] events."""
        s = self.slots[slot_idx]
        s.chunk_cursor += 1
        s.written = min(s.chunk_cursor * self.prefill_chunk,
                        len(s.prompt))
        if s.chunk_cursor < self.prefill_done_chunks(slot_idx):
            return []
        # final chunk: the sample at position P is the first new token
        s.written = len(s.prompt)
        s.phase = DECODE
        s.pending = int(token)
        replaying = bool(s.replay)
        if replaying:  # a continuation's first token is known: feed it
            s.pending = int(s.replay.pop(0))
        if self.prefix is not None:
            # cache the FULL prompt blocks (all their positions hold true
            # prompt KV, written by deterministic chunk-aligned prefill —
            # bitwise what any token-identical prompt would compute);
            # existing nodes win, new nodes ref-bump for the cache
            n_full = len(s.prompt) // self.block_size
            if n_full:
                self.prefix.insert(
                    s.prompt[:n_full * self.block_size],
                    s.blocks[:n_full], adapter=int(s.adapter),
                    pool=self.pool)
        if replaying:  # the sample is discarded
            return []
        return self._emit(slot_idx, int(token))

    def apply_decode(self, slot_idx: int, token: int) -> list[tuple]:
        s = self.slots[slot_idx]
        s.written += 1  # the step wrote pending's k/v at `written`
        if s.replay:  # replaying an emitted token: discard the sample
            s.pending = int(s.replay.pop(0))
            return []
        s.pending = int(token)
        return self._emit(slot_idx, int(token))

    def _emit(self, slot_idx: int, token: int) -> list[tuple]:
        s = self.slots[slot_idx]
        rid = s.rid
        self.emitted[rid].append(token)
        first = not self.first_emit[rid]
        self.first_emit[rid] = True
        s.budget -= 1
        s.emitted_here += 1
        self._tc(s.tenant)["tokens"] += 1
        done = s.budget == 0
        if done:
            self.pool.free(rid, s.blocks)
            self.slots[slot_idx] = None
            self.done.add(rid)
            self.finished[rid] = "done"
            self._tc(s.tenant)["done"] += 1
        return [(rid, token, first, done)]

    # ---- lifecycle: cancellation, deadlines (PR 11) ----------------------

    def cancel(self, rid: int) -> bool:
        """Client cancellation — honored at the NEXT step boundary (the
        sweep), never mid-launch, so the in-flight program completes and
        the ledger stays clean. Returns False for unknown/terminal rids
        (cancelling twice, or after completion, is a no-op)."""
        known = rid in self.emitted and rid not in self.finished
        if known:
            self._cancel_pending.add(rid)
        return known

    def _terminal_status(self, rid: int, now: float) -> str | None:
        if rid in self._cancel_pending:
            return "cancelled"
        arrival, ttft_dl, total_dl = self.meta.get(rid, (0.0, None, None))
        if total_dl is not None and now - arrival > total_dl:
            return "expired"
        if (ttft_dl is not None and not self.first_emit.get(rid, False)
                and now - arrival > ttft_dl):
            return "expired"
        return None

    def sweep(self, now: float) -> list[tuple]:
        """Step-boundary lifecycle sweep: pending cancellations and
        deadline breaches terminate requests HERE. Resident victims free
        their slot and blocks immediately (``check_leaks`` clean); queued
        victims (including preempted continuations — their clock is the
        ORIGINAL arrival in ``meta``) just leave the queue. Emits one
        terminal pseudo-event ``(rid, -1, False, True, status)`` per
        casualty; the already-emitted tokens remain in ``emitted`` as a
        bitwise prefix of the uninterrupted stream."""
        out = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            status = self._terminal_status(s.rid, now)
            if status:
                self.pool.free(s.rid, s.blocks)
                self.slots[i] = None
                out.append(self._finish(s.rid, status))
        if self.queue:
            keep = []
            for req in self.queue:
                status = self._terminal_status(req.rid, now)
                if status is None:
                    keep.append(req)
                else:
                    if self.store is not None:
                        self._drop_spill_record(req.rid)
                    if req.rid not in self.finished:
                        out.append(self._finish(req.rid, status))
            self.queue = keep
        self._cancel_pending.clear()
        return out

    def _finish(self, rid: int, status: str) -> tuple:
        self.finished[rid] = status
        if status == "cancelled":
            self.cancelled += 1
        else:
            self.expired += 1
        self._tc(self.tenant_of.get(rid, 0))[status] += 1
        return (rid, -1, False, True, status)

    # ---- prefix cache management -----------------------------------------

    def release_prefix_cache(self) -> int:
        """Drop the whole trie and release its block holds (engine close;
        also what makes ``check_leaks`` meaningful at shutdown). Returns
        the number of blocks released."""
        if self.prefix is None:
            return 0
        return self.prefix.drop(self.pool, store=self.store)

    # ---- snapshot / restore (PR 11) --------------------------------------

    def snapshot_state(self) -> dict:
        """JSON-serializable host state for the engine snapshot: every
        resident as a CONTINUATION (the ``_preempt`` transform — prompt
        plus emitted tail, remaining budget, same rng), residents first
        in admission order then the queue in order; plus the emitted /
        terminal maps and counters. The block pool and device cache are
        deliberately NOT captured — restore re-prefills each
        continuation (in this scheduler's ``continuations`` form, whose
        ``replay`` tokens ride in each entry), and position-derived
        sampling keys make the re-run land on the same stream bitwise."""
        requests = []
        live = sorted((s for s in self.slots if s is not None),
                      key=lambda s: s.admitted_seq)
        for s in live:
            prompt, replay = self._continuation(s)
            requests.append({
                "rid": int(s.rid),
                "prompt": [int(t) for t in prompt],
                "replay": list(replay),
                "budget": int(s.budget),
                "rng": [int(x) for x in np.asarray(s.rng).ravel()],
                "arrival": float("-inf"),  # already served once
                "tenant": int(s.tenant),
                "adapter": int(s.adapter),
            })
        for r in self.queue:
            requests.append({
                "rid": int(r.rid),
                "prompt": [int(t) for t in np.asarray(r.prompt)],
                "replay": [int(t) for t in r.replay],
                "budget": int(r.max_new_tokens),
                "rng": [int(x) for x in np.asarray(r.rng).ravel()],
                "arrival": float(r.arrival),
                "tenant": int(r.tenant),
                "adapter": int(r.adapter),
            })
        return {
            "requests": requests,
            "emitted": {str(k): [int(t) for t in v]
                        for k, v in self.emitted.items()},
            "first_emit": sorted(
                int(k) for k, v in self.first_emit.items() if v),
            "done": sorted(int(r) for r in self.done),
            "finished": {str(k): v for k, v in self.finished.items()},
            "meta": {str(k): [v[0], v[1], v[2]]
                     for k, v in self.meta.items()},
            "counters": {"seq": self._seq,
                         "preemptions": self.preemptions,
                         "shed": self.shed,
                         "cancelled": self.cancelled,
                         "expired": self.expired,
                         "prefix_hit_tokens": self.prefix_hit_tokens,
                         "prefill_tokens_saved": self.prefill_tokens_saved,
                         "prefix_evictions": self.prefix_evictions,
                         "spill_out_blocks": self.spill_out_blocks,
                         "spill_in_blocks": self.spill_in_blocks,
                         "spill_d2h_bytes": self.spill_d2h_bytes,
                         "spill_h2d_bytes": self.spill_h2d_bytes,
                         "spill_prefetched_blocks":
                             self.spill_prefetched_blocks,
                         "spill_resumes": self.spill_resumes,
                         "swapin_tokens_saved": self.swapin_tokens_saved,
                         "migrated_out": self.migrated_out,
                         "migrated_in": self.migrated_in},
            "tenant_of": {str(k): int(v)
                          for k, v in self.tenant_of.items()},
            "tenants": {str(k): dict(v)
                        for k, v in self.tenants.items()},
            # the prefix trie is deliberately NOT captured: it is host
            # state derived from token ids + deterministic prefills, and
            # the restoring engine's pool is zeroed — the trie rebuilds
            # itself as continuations re-prefill (bitwise-identical KV).
            # Spill RECORDS are likewise not captured (their payloads
            # are process RAM): a queued spilled continuation restores
            # as an ordinary continuation and re-prefills — or claims a
            # warm persisted prefix when the engine saved cache contents
            # (persist_cache).  Either way the stream is unchanged.
        }

    def restore_state(self, snap: dict) -> None:
        """Rebuild from :meth:`snapshot_state` output onto a FRESH
        scheduler (no residents, empty queue — the restoring engine owns
        a zeroed pool). Every snapshotted request re-enters as a queued
        continuation and re-prefills through normal admission."""
        if self.has_resident or self.queue:
            raise RuntimeError(
                "restore_state needs a fresh scheduler (residents or "
                "queue present)")
        self.queue = [
            Request(rid=int(r["rid"]),
                    prompt=np.asarray(r["prompt"], np.int32),
                    max_new_tokens=int(r["budget"]),
                    rng=np.asarray(r["rng"], np.uint32),
                    arrival=float(r["arrival"]),
                    tenant=int(r.get("tenant", 0)),
                    adapter=int(r.get("adapter", 0)),
                    replay=tuple(int(t) for t in r.get("replay", ())))
            for r in snap["requests"]
        ]
        self.emitted = {int(k): [int(t) for t in v]
                        for k, v in snap["emitted"].items()}
        self.first_emit = {rid: False for rid in self.emitted}
        for rid in snap["first_emit"]:
            self.first_emit[int(rid)] = True
        self.done = {int(r) for r in snap["done"]}
        self.finished = {int(k): v for k, v in snap["finished"].items()}
        self.meta = {
            int(k): (float(v[0]),
                     None if v[1] is None else float(v[1]),
                     None if v[2] is None else float(v[2]))
            for k, v in snap["meta"].items()
        }
        c = snap["counters"]
        self._seq = int(c["seq"])
        self.preemptions = int(c["preemptions"])
        self.shed = int(c["shed"])
        self.cancelled = int(c["cancelled"])
        self.expired = int(c["expired"])
        self.prefix_hit_tokens = int(c.get("prefix_hit_tokens", 0))
        self.prefill_tokens_saved = int(c.get("prefill_tokens_saved", 0))
        self.prefix_evictions = int(c.get("prefix_evictions", 0))
        self.spill_out_blocks = int(c.get("spill_out_blocks", 0))
        self.spill_in_blocks = int(c.get("spill_in_blocks", 0))
        self.spill_d2h_bytes = int(c.get("spill_d2h_bytes", 0))
        self.spill_h2d_bytes = int(c.get("spill_h2d_bytes", 0))
        self.spill_prefetched_blocks = int(
            c.get("spill_prefetched_blocks", 0))
        self.spill_resumes = int(c.get("spill_resumes", 0))
        self.swapin_tokens_saved = int(c.get("swapin_tokens_saved", 0))
        self.migrated_out = int(c.get("migrated_out", 0))
        self.migrated_in = int(c.get("migrated_in", 0))
        self.tenant_of = {int(k): int(v)
                          for k, v in snap.get("tenant_of", {}).items()}
        self.tenants = {int(k): {kk: int(vv) for kk, vv in v.items()}
                        for k, v in snap.get("tenants", {}).items()}

    # ---- introspection ---------------------------------------------------

    @property
    def has_resident(self) -> bool:
        return any(s is not None for s in self.slots)

    @property
    def has_queued(self) -> bool:
        return bool(self.queue)

    def next_arrival(self) -> float | None:
        if not self.queue:
            return None
        return float(min(r.arrival for r in self.queue))
