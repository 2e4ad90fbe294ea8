"""Fleet tier: global scheduling over a shard of per-replica engines.

A :class:`FleetScheduler` owns what must be GLOBAL for a scaled-out
server — admission (one door, one queue-depth gate), per-tenant
deficit-round-robin and quotas (fair-share holds fleet-wide, not
per-replica), and request->replica routing — while each replica stays a
stock :class:`~.engine.ServeEngine` running the same two step functions
(two CUDA graphs of its own on the card) over its own pool. This is the
JAX package's fleet; the host side is the same code.

Replicas and the card: every replica may sit on the same device (the
default: all on ``device``), and they share ONE :class:`Transformer`, whose
weights the serve path only reads; pass a list of models for weights of
one's own per replica. A replica then costs its pool
(``num_blocks`` x :func:`~.paged_cache.kv_block_bytes`), its two
captured graphs' private memory, and its staging buffers; no weights.
A replica on a mesh of more than one device is not ported (ROADMAP
Queue 1 item 3: NCCL on a card pair).

Three placement policies compose here:

* **Disaggregated prefill/decode** (``roles="disagg"``): prefill-role
  replicas run chunked prefill only; the moment a stream turns
  decode-phase its written KV blocks are exported (one fused d2h
  gather), shipped as a migration record, and adopted by a decode-role
  replica's host spill store, where the normal swap-in path resumes it.
  The transfer is counted (``migration_bytes``/``migration_secs``); the
  device-to-device form of the same handoff is
  ``parallel/multislice.make_kv_block_transfer``.
* **Fleet-level prefix routing** (``prefix_routing=True``): a request
  routes to the replica already holding its longest cached prefix
  (probed against each candidate's radix trie) before falling back to
  least-loaded, so prefix locality concentrates instead of diluting
  across the fleet.
* **Elastic capacity** (``world_chaos=``): ``slice_loss`` /
  ``slice_return`` faults drive replica shed/reabsorb through the
  placement tier with :class:`~..train.elastic_world.ElasticSupervisor`
  semantics — a generation counter, a timeline entry per world change,
  and every live stream of a lost replica RE-ANCHORED (the continuation
  transform, KV lost with the replica) onto the fleet queue front.  The
  autoscale signal joins the TTFT-EWMA with queue pressure and goodput
  counters; ``apply_autoscale=True`` closes the loop (add a provisioned
  cold replica / retire one by graceful drain).

Crash consistency: the fleet keeps its own ADMISSION LEDGER — each
stream's continuation basis recorded at dispatch, its emitted tail
folded in from the event stream — so a replica HARD CRASH
(``replica_crash`` chaos: no orderly ``detach_stream``, the engine
object and its KV gone) rebuilds every resident from supervisor-side
state alone and re-anchors it queue-front. The dead engine is closed
(its graphs and pool freed) and a fresh one takes its place, capturing
one new pair of graphs at its first steps. A per-replica CIRCUIT
BREAKER trips on consecutive step failures (ejection → bounded backoff
→ half-open probe → recovery), stalled replicas (``replica_stall``: the
watchdog's tick-deadline verdict) sit out a recovery window, and
neither receives new work while excluded.  Handoff records carry a
unique adoption id: a torn migration (``migration_torn`` duplicates the
record in flight) is adopted exactly once.  ``save_snapshot`` /
``restore_latest_snapshot`` persist the WHOLE fleet — global queue,
deficits, tenant counters, ledger, breaker/drain state, and every
replica's engine snapshot — through ``train/checkpoint.py``'s
manifested / CRC ladder.

Continuations travel in the replicas' form (the engine's
``continuations``: ``"replay"`` on the card, ``"prefill"`` on the CPU):
every re-anchor, and the crash rebuild from the ledger, hands the target
the base prompt plus the tokens to feed back through decode steps on the
card, where re-prefilling emitted tokens in a chunk would give their
cache rows other bits than the decode steps that first wrote them.

Guarantees: every stream — routed anywhere, migrated mid-flight,
re-anchored through a replica loss, hard crash, stall, ejection or
drain, or restored from a fleet snapshot — is bitwise identical to the
stream of one uninterrupted engine with the same geometry
(position-derived sampling keys; KV migration ships the same bytes the
source wrote).  Per-tenant counters aggregate across replicas as a
DISJOINT sum: ``submitted`` counts once where the stream was first
dispatched, the terminal status once where it ended, migration bypasses
``submit`` by contract, and a crashed engine's terminal accounting
survives in the fleet graveyard.  Non-guarantees: there is no
cross-replica event-log identity (each replica's flight recorder sees
only its own residency); hard-crash recovery LOSES the replica's KV —
it is re-anchoring (the cache rebuilt from the recorded position); the
breaker's granularity is the step boundary (a fault is detected when the
tick that hit it returns, not mid-kernel); autoscale apply is
drain-based and never drops a stream, so scale-down completes only
after residents migrate or finish.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.models.generation import (
    host_array,
)
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    EngineOverloaded,
    Event,
    Request,
    ServeEngine,
)
from distributed_tensorflow_guide_tpu_torch.serve.scheduler import Scheduler

__all__ = ["FleetScheduler"]

ROLES = ("colocated", "prefill", "decode")


@dataclasses.dataclass
class _Item:
    """One fleet-queue entry: a fresh request, or a migration record
    (adoption instead of submission) with a request VIEW of the record
    for DRR/quota accounting."""

    req: Request
    record: dict | None = None


class FleetScheduler:
    """Global admission + DRR + routing over N ServeEngine replicas.

    >>> fleet = FleetScheduler(cfg, model, replicas=2, slots=4,
    ...                        num_blocks=33, block_size=8,
    ...                        prefill_chunk=16)
    >>> fleet.submit(Request(rid=0, prompt=toks, max_new_tokens=16,
    ...                      rng=np.array([0, 7], np.uint32)))
    >>> fleet.run()
    >>> fleet.completions()[0]

    ``model`` is one :class:`Transformer` every replica serves, or a list
    of one per replica. ``replicas`` is a count (every replica on
    ``device``, default the first CUDA card) or a list of one device per
    replica; a list or tuple of several devices for one replica (its own
    DP x TP mesh) raises NotImplementedError (ROADMAP Queue 1 item 3).
    ``continuations`` is passed to every replica's engine (default: the
    engine's own by device).
    """

    def __init__(self, cfg, model, *, replicas=2,
                 roles="colocated",
                 slots: int, num_blocks: int, block_size: int,
                 prefill_chunk: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 adapters=None,
                 max_queue: int | None = None,
                 tenant_quotas=None, drr_quantum: int | None = None,
                 prefix_cache: bool = False,
                 prefix_routing: bool | None = None,
                 host_blocks: int = 0,
                 chaos=None, world_chaos=None, fleet_chaos=None,
                 breaker_threshold: int = 3,
                 breaker_backoff_ticks: int = 4,
                 breaker_max_backoff_ticks: int = 32,
                 stall_recovery_ticks: int = 3,
                 apply_autoscale: bool = False,
                 autoscale_params: dict | None = None,
                 autoscale_every: int = 4,
                 snapshot_dir=None, snapshot_keep: int = 3,
                 burst_factory=None, recorder=None,
                 continuations: str | None = None, device=None) -> None:
        if isinstance(replicas, int):
            devices = [resolve_device(device)] * max(replicas, 0)
        else:
            devices = []
            for d in replicas:
                if isinstance(d, (list, tuple)):
                    if len(d) > 1:
                        raise NotImplementedError(
                            "a replica on a mesh of several devices is not "
                            "ported yet: ROADMAP Queue 1 item 3 (NCCL on a "
                            "card pair)")
                    d = d[0]
                devices.append(resolve_device(d))
            replicas = len(devices)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        if breaker_backoff_ticks < 1:
            raise ValueError(
                f"breaker_backoff_ticks must be >= 1, got "
                f"{breaker_backoff_ticks}")
        if breaker_max_backoff_ticks < breaker_backoff_ticks:
            raise ValueError(
                f"breaker_max_backoff_ticks {breaker_max_backoff_ticks} "
                f"< breaker_backoff_ticks {breaker_backoff_ticks}")
        if stall_recovery_ticks < 1:
            raise ValueError(
                f"stall_recovery_ticks must be >= 1, got "
                f"{stall_recovery_ticks}")
        if autoscale_every < 1:
            raise ValueError(
                f"autoscale_every must be >= 1, got {autoscale_every}")
        if roles == "colocated":
            role_list = ["colocated"] * replicas
        elif roles == "disagg":
            if replicas < 2:
                raise ValueError(
                    "disagg needs >= 2 replicas (one per role)")
            # alternate so any fleet width gets both roles; prefill first
            role_list = ["prefill" if i % 2 == 0 else "decode"
                         for i in range(replicas)]
        else:
            role_list = [str(r) for r in roles]
            if len(role_list) != replicas:
                raise ValueError(
                    f"roles length {len(role_list)} != replicas "
                    f"{replicas}")
            for r in role_list:
                if r not in ROLES:
                    raise ValueError(f"unknown role {r!r}")
        if ("decode" in role_list) != ("prefill" in role_list):
            raise ValueError(
                "prefill and decode roles come as a pair — a role split "
                "with only one side cannot serve")
        self.roles = role_list
        self.disagg = "prefill" in role_list
        self.prefix_routing = (prefix_cache if prefix_routing is None
                               else bool(prefix_routing))
        if self.prefix_routing and not prefix_cache:
            raise ValueError(
                "prefix_routing needs prefix_cache=True (the per-replica "
                "tries are what routing probes)")
        chaos_list = (chaos if isinstance(chaos, (list, tuple))
                      else [chaos] * replicas)
        if len(chaos_list) != replicas:
            raise ValueError(
                f"chaos list length {len(chaos_list)} != replicas "
                f"{replicas}")
        self.rec = (recorder if recorder is not None
                    else obs_events.current())
        # one model every replica serves (the serve path only reads its
        # weights), or one per replica
        models = (list(model) if isinstance(model, (list, tuple))
                  else [model] * replicas)
        if len(models) != replicas:
            raise ValueError(
                f"model list length {len(models)} != replicas {replicas}")
        self._cfg = cfg
        self._models = models
        self.engines: list[ServeEngine] = []
        self._engine_kw: list[dict] = []
        for i, role in enumerate(role_list):
            # adoptable replicas get a host-store landing pad at least
            # one full pool deep: migrated KV blocks arrive THERE and
            # resume by the normal swap-in path.  Replica-level quotas
            # and queue gates are OFF — fair-share and the door gate are
            # fleet-global by design.
            hb = host_blocks
            if self.disagg and role != "prefill":
                hb = max(host_blocks, num_blocks)
            kw = dict(slots=slots, num_blocks=num_blocks,
                      block_size=block_size, prefill_chunk=prefill_chunk,
                      temperature=temperature, top_k=top_k,
                      adapters=adapters,
                      max_queue=None, chaos=chaos_list[i],
                      burst_factory=burst_factory,
                      prefix_cache=prefix_cache, host_blocks=hb,
                      tenant_quotas=None, drr_quantum=None,
                      recorder=recorder, continuations=continuations,
                      device=devices[i])
            self._engine_kw.append(kw)
            self.engines.append(ServeEngine(cfg, models[i], **kw))
        self.num_slots = slots
        self.block_size = block_size
        self.max_queue = max_queue
        self.tenant_quotas = {int(t): dict(q) for t, q in
                              (tenant_quotas or {}).items()}
        sched0 = self.engines[0].sched
        #: the replicas' continuation form (one per fleet: same devices'
        #: kind); the crash rebuild writes its records in it
        self.continuations = sched0.continuations
        self.drr_quantum = (sched0.blocks_per_seq if drr_quantum is None
                            else int(drr_quantum))
        if self.drr_quantum < 1:
            raise ValueError(
                f"drr_quantum must be >= 1, got {self.drr_quantum}")
        self._deficit: dict[int, int] = {}
        self.queue: list[_Item] = []
        self.world = world_chaos
        self._live: set[int] = set(range(replicas))
        self._tick = 0
        # fleet counters (what a benchmark reconciles the migration
        # traffic against)
        self.shed = 0
        self.migrations = 0
        self.migration_bytes = 0
        self.migration_secs = 0.0
        self.migrated_rids: list[int] = []
        self.prefix_route_hits = 0
        self.prefix_route_hit_tokens = 0
        self.generation = 0
        self.replicas_shed = 0
        self.replicas_regrown = 0
        self.timeline: list[dict] = []
        self._fleet_tenants: dict[int, dict[str, int]] = {}
        # autoscale_policy hysteresis state: the direction the signal
        # has been leaning and for how many consecutive evaluations
        self._scale_direction = 0
        self._scale_streak = 0
        # ---- crash consistency + self-healing ---------------------------
        self.fleet_chaos = fleet_chaos
        self.breaker_threshold = breaker_threshold
        self.breaker_backoff_ticks = breaker_backoff_ticks
        self.breaker_max_backoff_ticks = breaker_max_backoff_ticks
        self.stall_recovery_ticks = stall_recovery_ticks
        self.apply_autoscale = apply_autoscale
        self.autoscale_params = dict(autoscale_params or {})
        self.autoscale_every = autoscale_every
        # the fleet ADMISSION LEDGER: everything the supervisor needs to
        # reconstruct a replica's residents after a hard crash, recorded
        # at dispatch (identity) and from the event stream (tokens) —
        # never read back from a dead engine
        self._ledger: dict[int, dict] = {}
        self._ledger_seq = 0
        # exactly-once migration adoption: (rid, handoff id) pairs
        # already adopted; a torn handoff's duplicate record carries the
        # SAME handoff id and is dropped idempotently at dispatch
        self._adopted: set[tuple[int, int]] = set()
        self._handoff_seq = 0
        self._torn_pending = 0  # armed migration_torn faults
        # per-replica circuit breaker: consecutive step failures trip it
        # open; a half-open probe after bounded backoff closes it again
        self._breaker = [
            {"state": "closed", "fails": 0,
             "backoff": breaker_backoff_ticks, "until": 0}
            for _ in range(replicas)]
        self._stalled: dict[int, int] = {}   # replica -> recover-at tick
        self._draining: set[int] = set()     # autoscale drain victims
        self.replica_crashes = 0
        self.replica_stalls = 0
        self.breaker_ejections = 0
        self.breaker_probes = 0
        self.breaker_recoveries = 0
        self.replica_faults = 0
        self.migration_dups_dropped = 0
        self.autoscale_added = 0
        self.autoscale_retired = 0
        # the graveyard: terminal accounting harvested from crashed
        # engines (the monitoring plane's last scrape) so completions
        # and per-tenant counters survive the object's replacement
        self._grave_completions: dict[int, list[int]] = {}
        self._grave_tenants: dict[int, dict[str, int]] = {}
        self._grave_counters = {"completed": 0, "shed": 0}
        # fleet snapshot/restore through the manifested/CRC checkpointer
        self.snapshot_dir = snapshot_dir
        self._ckpt = None
        self._last_snap = -1
        if snapshot_dir is not None:
            from distributed_tensorflow_guide_tpu_torch.train.checkpoint \
                import Checkpointer
            self._ckpt = Checkpointer(snapshot_dir,
                                      max_to_keep=snapshot_keep,
                                      recorder=self.rec)

    # ---- intake ----------------------------------------------------------

    def _ft(self, tenant: int) -> dict[str, int]:
        return self._fleet_tenants.setdefault(int(tenant), {"shed": 0})

    def submit(self, req: Request) -> None:
        """The fleet door: cheap validation plus the GLOBAL queue-depth
        gate (replicas run ungated).  Nothing is recorded for a shed
        request — :class:`EngineOverloaded` stays retriable."""
        cfg = self.engines[0].fns.cfg
        sched0 = self.engines[0].sched
        prompt = host_array(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if int(prompt.max()) >= cfg.vocab_size:
            raise ValueError("prompt token out of vocabulary")
        if req.tenant < 0:
            raise ValueError(f"tenant must be >= 0, got {req.tenant}")
        if prompt.size + req.max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new {req.max_new_tokens} "
                f"exceeds max_len {cfg.max_len}")
        need = sched0.max_request_blocks(prompt.size, req.max_new_tokens)
        if need > sched0.pool.capacity:
            raise ValueError(
                f"request {req.rid} can never fit: needs {need} blocks, "
                f"pool capacity {sched0.pool.capacity}")
        quota = self.tenant_quotas.get(int(req.tenant), {})
        if quota.get("blocks") is not None and need > quota["blocks"]:
            raise ValueError(
                f"request {req.rid} can never fit tenant {req.tenant}'s "
                f"block quota: needs {need}, quota {quota['blocks']}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed += 1
            self._ft(req.tenant)["shed"] += 1
            if self.rec.enabled:
                self.rec.emit(
                    "req.shed", cat="serve", actor="fleet",
                    payload={"rid": req.rid, "reason": "queue_depth",
                             "tenant": int(req.tenant),
                             "queue_depth": len(self.queue)},
                    t=float(req.arrival))
            raise EngineOverloaded(
                f"request {req.rid} shed: fleet queue depth "
                f"{len(self.queue)} at the max_queue={self.max_queue} "
                "gate — retry later")
        self.queue.append(_Item(req=dataclasses.replace(
            req, prompt=prompt, rng=host_array(req.rng, np.uint32))))

    def cancel(self, rid: int) -> bool:
        """Client abandon, fleet-wide: drop a fleet-queued item outright,
        or forward to whichever replica holds the stream."""
        for j, item in enumerate(self.queue):
            if item.req.rid == rid:
                self.queue.pop(j)
                return True
        return any(self.engines[i].cancel(rid)
                   for i in sorted(self._live))

    # ---- global DRR dispatch ---------------------------------------------

    def _tenant_heads(self) -> list[tuple[_Item, int]]:
        heads: list[tuple[_Item, int]] = []
        seen: set[int] = set()
        for item in self.queue:
            t = int(item.req.tenant)
            if t not in seen:
                seen.add(t)
                heads.append((item, t))
        return heads

    def _load(self, i: int) -> int:
        sd = self.engines[i].sched
        return sum(s is not None for s in sd.slots) + len(sd.queue)

    def _store_room(self, i: int) -> int:
        st = self.engines[i].store
        if st is None:
            return 0
        if st.capacity is None:
            return 1 << 30
        return st.capacity - st.live_blocks()

    def _quota_allows(self, tenant: int, req: Request) -> bool:
        """Fleet-wide committed usage: worst-case footprints of the
        tenant's residents AND replica-queued requests across every live
        replica — dispatch is the commitment point, so the global quota
        can never be overrun by replicas admitting independently."""
        quota = self.tenant_quotas.get(int(tenant))
        if not quota:
            return True
        slots_used = 0
        committed = 0
        for i in sorted(self._live):
            sd = self.engines[i].sched
            for s in sd.slots:
                if s is not None and s.tenant == tenant:
                    slots_used += 1
                    committed += s.max_blocks
            for r in sd.queue:
                if int(r.tenant) == tenant:
                    slots_used += 1
                    committed += sd.max_request_blocks(
                        len(r.prompt), len(r.replay) + r.max_new_tokens)
        if (quota.get("slots") is not None
                and slots_used >= quota["slots"]):
            return False
        if quota.get("blocks") is not None:
            cost = self.engines[0].sched.max_request_blocks(
                len(req.prompt), len(req.replay) + req.max_new_tokens)
            if committed + cost > quota["blocks"]:
                return False
        return True

    def _route(self, item: _Item) -> int | None:
        """The routing policy, in preference order: (1) a KV-carrying
        migration record goes to the least-loaded adoptable replica with
        store room; (2) a re-prefill item probes the prefix tries and
        goes to the longest cached prefix when routing is on; (3)
        least-loaded wins, lowest index breaking ties.  Only replicas
        with a free-ish slot budget (load < slots) are candidates — the
        fleet queue, not replica queues, is where work waits, which is
        what keeps the global DRR in charge.  Every candidate list
        filters through :meth:`_routable` — open/half-open breakers,
        stalled and draining replicas never receive new work."""
        rec = item.record
        payloads = (rec or {}).get("payloads") or []
        routable = [i for i in sorted(self._live) if self._routable(i)]
        if payloads:
            cands = [i for i in routable
                     if self.roles[i] != "prefill"
                     and self.engines[i].store is not None
                     and self._store_room(i) >= len(payloads)
                     and self._load(i) < self.engines[i].num_slots]
            if not cands:
                return None
            return min(cands, key=lambda i: (self._load(i), i))
        if self.disagg:
            cands = [i for i in routable
                     if self.roles[i] == "prefill"]
            if not cands:  # every prefill replica shed: degrade, not die
                cands = routable
        else:
            cands = routable
        cands = [i for i in cands
                 if self._load(i) < self.engines[i].num_slots]
        if not cands:
            return None
        if self.prefix_routing:
            best, hit = None, 0
            for i in cands:
                sd = self.engines[i].sched
                if sd.prefix is None:
                    continue
                n = len(sd.prefix.match_nodes(
                    item.req.prompt, adapter=int(item.req.adapter)))
                if n > hit:
                    best, hit = i, n
            if best is not None and hit > 0:
                self.prefix_route_hits += 1
                self.prefix_route_hit_tokens += hit * self.block_size
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.prefix_route", cat="serve", actor="fleet",
                        payload={"rid": item.req.rid, "replica": best,
                                 "hit_tokens": hit * self.block_size})
                return best
        return min(cands, key=lambda i: (self._load(i), i))

    def _dispatch(self, now: float) -> int:
        """Global deficit-round-robin over per-tenant fleet-queue heads —
        the same loop shape as :meth:`Scheduler.admit`, with "a replica
        accepted it" in place of "blocks were found".  Migration records
        dispatch through ``adopt_stream`` (never re-counting
        ``submitted``); fresh requests through the replica's ``submit``,
        whose predicted-TTFT gate may still shed (counted there, exactly
        as a single engine would have)."""
        sched0 = self.engines[0].sched
        dispatched = 0
        while self.queue:
            progressed = False
            deficit_waiting = False
            for item, tenant in self._tenant_heads():
                if item.record is not None:
                    # exactly-once adoption: a torn handoff's duplicate
                    # carries the same (rid, handoff) key — drop it
                    # idempotently before any deficit/quota bookkeeping
                    key = (int(item.record["rid"]),
                           int(item.record.get("handoff", -1)))
                    if key in self._adopted:
                        self.queue.pop(next(
                            j for j, it in enumerate(self.queue)
                            if it is item))
                        self.migration_dups_dropped += 1
                        if self.rec.enabled:
                            self.rec.emit(
                                "fleet.migrate_dup", cat="serve",
                                actor="fleet",
                                payload={"rid": key[0],
                                         "handoff": key[1]},
                                t=now)
                        progressed = True
                        continue
                if item.req.arrival > now:
                    continue
                if not self._quota_allows(tenant, item.req):
                    continue
                cost = sched0.max_request_blocks(
                    len(item.req.prompt),
                    len(item.req.replay) + item.req.max_new_tokens)
                self._deficit[tenant] = (self._deficit.get(tenant, 0)
                                         + self.drr_quantum)
                if self._deficit[tenant] < cost:
                    deficit_waiting = True
                    continue
                target = self._route(item)
                if target is None:
                    continue
                self.queue.pop(next(
                    j for j, it in enumerate(self.queue) if it is item))
                eng = self.engines[target]
                if item.record is not None:
                    eng.adopt_stream(item.record)
                    self._adopted.add(
                        (int(item.record["rid"]),
                         int(item.record.get("handoff", -1))))
                    self._ledger_note(item, target)
                else:
                    try:
                        eng.submit(item.req)
                    except EngineOverloaded:
                        pass  # TTFT-gate shed, counted by the replica
                    else:
                        self._ledger_note(item, target)
                self._deficit[tenant] -= cost
                dispatched += 1
                progressed = True
            if not progressed and not deficit_waiting:
                break
        queued = {int(it.req.tenant) for it in self.queue}
        for t in [t for t in self._deficit if t not in queued]:
            del self._deficit[t]
        return dispatched

    # ---- the admission ledger (crash reconstruction's only source) -------

    def _ledger_note(self, item: _Item, target: int) -> None:
        """Record a dispatch in the fleet's own ledger: the continuation
        BASIS (prompt/budget/rng at dispatch, plus any history that
        travelled in on a record) and the owning replica.  Tokens the
        replica emits land in ``since`` via :meth:`_observe` — so a hard
        crash can rebuild the stream without touching the dead engine."""
        req, rec = item.req, (item.record or {})
        m = rec.get("meta")
        if m is None and item.record is None:
            m = [float(req.arrival), req.ttft_deadline_s, req.deadline_s]
        self._ledger_seq += 1
        self._ledger[int(req.rid)] = {
            "seq": self._ledger_seq,
            "prompt": np.asarray(req.prompt, np.int32).reshape(-1),
            "replay": [int(t) for t in req.replay],
            "budget": int(req.max_new_tokens),
            "rng": np.asarray(req.rng, np.uint32),
            "arrival": float(req.arrival),
            "tenant": int(req.tenant), "adapter": int(req.adapter),
            "emitted_prior": [int(t) for t in rec.get("emitted", [])],
            "first_emit_prior": bool(rec.get("first_emit", False)),
            "meta": None if m is None else [m[0], m[1], m[2]],
            "since": [],
            "owner": int(target),
            "done": False,
        }

    def _observe(self, i: int, evs: list[Event]) -> None:
        """Fold a replica's tick events into the ledger — the
        supervisor's view of each stream's emitted tail, maintained
        BEFORE any crash so reconstruction never needs the replica."""
        for e in evs:
            ent = self._ledger.get(e.rid)
            if ent is None or ent["owner"] != i:
                continue
            if e.status == "ok" and e.token >= 0:
                ent["since"].append(int(e.token))
            if e.done:
                ent["done"] = True

    def _stamp_handoff(self, record: dict) -> dict:
        """Give a migration / re-anchor record its adoption identity:
        the fleet generation it left in, and a unique handoff id — the
        exactly-once key (a resent duplicate copies the id; a later
        legitimate re-handoff of the same rid gets a fresh one)."""
        self._handoff_seq += 1
        record["fleet_gen"] = self.generation
        record["handoff"] = self._handoff_seq
        return record

    def _insert_handoffs(self, items: list[_Item],
                         now: float = 0.0) -> None:
        """Queue-front insertion of handoff records, applying any armed
        ``migration_torn`` faults: the duplicate record (same handoff
        id) rides immediately behind the original, and the adoption
        ledger must swallow it exactly once."""
        out: list[_Item] = []
        for it in items:
            out.append(it)
            if self._torn_pending > 0 and it.record is not None:
                self._torn_pending -= 1
                dup = _Item(req=self._record_req(it.record),
                            record=dict(it.record))
                out.append(dup)
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.migration_torn", cat="serve",
                        actor="fleet",
                        payload={"rid": int(it.record["rid"]),
                                 "handoff": int(it.record["handoff"])},
                        t=now)
        self.queue[:0] = out

    # ---- disaggregation: prefill -> decode migration ---------------------

    def _migrate_prefilled(self, now: float) -> int:
        """Ship every stream that just turned decode-phase on a
        prefill-role replica to a decode-role replica: fused d2h export
        of its written KV blocks, re-anchored through the fleet queue
        FRONT (adopted next tick by the normal swap-in path).  When no
        decode replica has store room the stream simply keeps decoding
        where it is — degraded placement, never a dropped stream."""
        moved = 0
        for i in sorted(self._live):
            if self.roles[i] != "prefill":
                continue
            eng = self.engines[i]
            ready = sorted(
                (s for s in eng.sched.slots
                 if s is not None and s.phase == "decode"
                 and s.written >= 1 and s.budget > 0),
                key=lambda s: s.admitted_seq)
            for s in ready:
                n_blocks = len(eng.sched.migratable_blocks(s.rid))
                if not n_blocks:
                    continue
                has_target = any(
                    self.roles[j] != "prefill"
                    and self.engines[j].store is not None
                    and self._store_room(j) >= n_blocks
                    for j in self._live
                    if j != i and self._routable(j))
                if not has_target:
                    continue
                t0 = time.perf_counter()
                record = eng.export_stream(s.rid, with_kv=True)
                self.migration_secs += time.perf_counter() - t0
                self.migrations += 1
                self.migration_bytes += int(record["payload_bytes"])
                self.migrated_rids.append(int(record["rid"]))
                self._stamp_handoff(record)
                ent = self._ledger.get(int(record["rid"]))
                if ent is not None:
                    ent["owner"] = None  # in flight, owned by no replica
                self._insert_handoffs(
                    [_Item(req=self._record_req(record), record=record)],
                    now)
                moved += 1
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.migrate", cat="serve", actor="fleet",
                        payload={"rid": int(record["rid"]),
                                 "from": i, "blocks": n_blocks,
                                 "bytes": int(record["payload_bytes"])},
                        t=now)
        return moved

    @staticmethod
    def _record_req(record: dict) -> Request:
        return Request(
            rid=int(record["rid"]),
            prompt=np.asarray(record["prompt"], np.int32),
            max_new_tokens=int(record["budget"]),
            rng=np.asarray(record["rng"], np.uint32),
            arrival=float(record.get("arrival", float("-inf"))),
            tenant=int(record.get("tenant", 0)),
            adapter=int(record.get("adapter", 0)),
            replay=tuple(int(t) for t in record.get("replay", ())))

    # ---- elastic capacity: replica shed / reabsorb -----------------------

    def _apply_world(self, tick: int, now: float) -> None:
        if self.world is None:
            return
        due = [f for f in self.world.world_events() if f.position <= tick]
        for f in due:
            self.world.fire(f)
            idx = f.slice_id % len(self.engines)
            if f.kind == "slice_loss":
                if idx in self._live and len(self._live) > 1:
                    self._shed_replica(idx)
                    self.replicas_shed += 1
            elif f.kind == "slice_return":
                if idx not in self._live:
                    self._live.add(idx)
                    self.replicas_regrown += 1
            self.generation += 1
            self.timeline.append({
                "generation": self.generation, "tick": tick,
                "kind": f.kind, "replica": idx,
                "live": sorted(self._live),
                "signal": self.autoscale_signal()})
            if self.rec.enabled:
                self.rec.emit(
                    "fleet.world", cat="serve", actor="fleet",
                    payload={"kind": f.kind, "replica": idx,
                             "generation": self.generation,
                             "live": sorted(self._live)},
                    t=now)

    def _reanchor_streams(self, idx: int, *, drop_caches: bool,
                          now: float = 0.0) -> int:
        """ORDERLY re-anchor of a replica's live streams onto the fleet
        queue FRONT in admission-then-queue order (the
        ``snapshot_state`` convention): the continuation transform with
        the KV left behind, so each re-prefills elsewhere and continues
        bitwise.  This is the graceful path — the replica's host state
        is reachable (world shed, stall, breaker ejection); a HARD crash
        goes through :meth:`_crash_replica`, which never touches the
        dead engine.  Returns the number of streams re-anchored."""
        eng = self.engines[idx]
        sd = eng.sched
        live = sorted((s for s in sd.slots if s is not None),
                      key=lambda s: s.admitted_seq)
        rids = [s.rid for s in live] + [r.rid for r in sd.queue]
        items = []
        for rid in rids:
            record = self._stamp_handoff(
                eng.export_stream(rid, with_kv=False))
            ent = self._ledger.get(int(rid))
            if ent is not None:
                ent["owner"] = None
            items.append(_Item(req=self._record_req(record),
                               record=record))
        self._insert_handoffs(items, now)
        if drop_caches:
            sd.release_prefix_cache()
            if eng.store is not None:
                sd.release_spill_store()
        return len(items)

    def _shed_replica(self, idx: int) -> None:
        """World-event replica loss: streams re-anchor, the engine
        OBJECT is retained for accounting — completed streams and
        tenant counters persist supervisor-side, exactly like a
        training generation's report outliving its processes — and
        comes back cold (trie and spill store dropped) if a
        ``slice_return`` reabsorbs it."""
        self._reanchor_streams(idx, drop_caches=True)
        self._live.discard(idx)
        self._draining.discard(idx)
        self._stalled.pop(idx, None)

    # ---- fleet chaos: hard crash, stall, torn handoff --------------------

    def _apply_fleet_chaos(self, tick: int, now: float) -> None:
        if self.fleet_chaos is None:
            return
        self.fleet_chaos.recorder = self.rec
        self.fleet_chaos.obs_now = now
        for f in self.fleet_chaos.take_fleet(tick):
            if f.kind == "replica_crash":
                idx = int(f.param) % len(self.engines)
                if idx in self._live:
                    self._crash_replica(idx, tick, now)
            elif f.kind == "replica_stall":
                idx = int(f.param) % len(self.engines)
                if idx in self._live:
                    self._stall_replica(idx, tick, now)
            else:  # migration_torn: the NEXT handoff record resends
                self._torn_pending += 1

    def _crash_replica(self, idx: int, tick: int, now: float) -> None:
        """Replica hard-crash: the engine (and its KV) is GONE with no
        orderly ``detach_stream``.  Terminal accounting is harvested
        into the graveyard (the monitoring plane's last scrape); every
        live stream is rebuilt from the fleet's OWN admission ledger —
        base prompt at dispatch plus the tokens the supervisor observed
        — and re-anchored queue-front as a continuation, in the
        replicas' continuations form.  The dead engine is closed (its
        graphs, pool and staging buffers freed) and a FRESH engine (one
        new pair of graphs captured at its first steps) takes the slot and
        returns through the breaker's half-open probe."""
        eng = self.engines[idx]
        self.generation += 1
        self._harvest(eng)
        ents = sorted(
            ((rid, ent) for rid, ent in self._ledger.items()
             if ent["owner"] == idx and not ent["done"]),
            key=lambda kv: kv[1]["seq"])
        items = []
        for rid, ent in ents:
            since = ent["since"]
            # the continuation in the replicas' form: the base prompt at
            # dispatch, then every token fed back or observed since,
            # either prefilled with it or fed back through decode steps
            tail = ent["replay"] + since
            prompt, replay = ent["prompt"], None
            if self.continuations == "replay":
                replay = tail
            elif tail:
                prompt = np.concatenate(
                    [prompt, np.asarray(tail, np.int32)])
            record = Scheduler.continuation_record(
                rid=rid, prompt=prompt, replay=replay,
                budget=ent["budget"] - len(since),
                rng=ent["rng"],
                emitted=ent["emitted_prior"] + since,
                tenant=ent["tenant"], adapter=ent["adapter"],
                first_emit=ent["first_emit_prior"] or bool(since),
                meta=ent["meta"])
            self._stamp_handoff(record)
            ent["owner"] = None
            items.append(_Item(req=self._record_req(record),
                               record=record))
        self._insert_handoffs(items, now)
        # the dead engine's graphs and pool go with it: a crash must not
        # leave a pool behind on the card
        eng.close()
        self.engines[idx] = ServeEngine(
            self._cfg, self._models[idx], **self._engine_kw[idx])
        self._live.discard(idx)
        self._draining.discard(idx)
        self._stalled.pop(idx, None)
        br = self._breaker[idx]
        br["state"] = "open"
        br["fails"] = 0
        br["until"] = tick + 1 + br["backoff"]
        self.replica_crashes += 1
        self.timeline.append({
            "generation": self.generation, "tick": tick,
            "kind": "replica_crash", "replica": idx,
            "live": sorted(self._live),
            "signal": self.autoscale_signal()})
        if self.rec.enabled:
            self.rec.emit(
                "fleet.replica_crash", cat="serve", actor="fleet",
                payload={"replica": idx, "reanchored": len(items),
                         "generation": self.generation,
                         "probe_tick": br["until"]},
                t=now)

    def _harvest(self, eng: ServeEngine) -> None:
        """Last scrape of a crashing engine: TERMINAL streams' emitted
        history and per-tenant counters move to the fleet graveyard so
        fleet-merged completions and the disjoint-sum tenant accounting
        survive the object's replacement.  Live streams are NOT read —
        they are the ledger's job."""
        sd = eng.sched
        for rid in sd.finished:
            toks = sd.emitted.get(rid)
            if toks is not None:
                self._grave_completions[int(rid)] = [int(t) for t in toks]
        for t, c in sd.tenants.items():
            agg = self._grave_tenants.setdefault(int(t), {})
            for k, v in c.items():
                agg[k] = agg.get(k, 0) + int(v)
        self._grave_counters["completed"] += len(sd.done)
        self._grave_counters["shed"] += sd.shed

    def _stall_replica(self, idx: int, tick: int, now: float) -> None:
        """The watchdog's verdict, delivered deterministically: the
        device queue is wedged but the HOST process is reachable, so
        streams detach orderly (KV left behind — the device is
        unreachable) and re-anchor while the replica sits out its
        recovery window.  Its warm caches stay (the process never
        died); it rejoins at the deadline."""
        self.generation += 1
        n = self._reanchor_streams(idx, drop_caches=False, now=now)
        self._live.discard(idx)
        self._draining.discard(idx)
        self._stalled[idx] = tick + self.stall_recovery_ticks
        self.replica_stalls += 1
        self.timeline.append({
            "generation": self.generation, "tick": tick,
            "kind": "replica_stall", "replica": idx,
            "live": sorted(self._live),
            "signal": self.autoscale_signal()})
        if self.rec.enabled:
            self.rec.emit(
                "fleet.replica_stall", cat="serve", actor="fleet",
                payload={"replica": idx, "reanchored": n,
                         "recover_tick": self._stalled[idx]},
                t=now)

    def _stall_tick(self, tick: int, now: float) -> None:
        for idx in sorted(self._stalled):
            if tick >= self._stalled[idx]:
                del self._stalled[idx]
                self._live.add(idx)
                self.generation += 1
                self.timeline.append({
                    "generation": self.generation, "tick": tick,
                    "kind": "replica_recovered", "replica": idx,
                    "live": sorted(self._live),
                    "signal": self.autoscale_signal()})
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.replica_recovered", cat="serve",
                        actor="fleet",
                        payload={"replica": idx, "via": "stall_deadline"},
                        t=now)

    # ---- per-replica circuit breaker -------------------------------------

    def _routable(self, i: int) -> bool:
        """Replicas the router may hand NEW work: live, breaker closed,
        not wedged, not draining.  A half-open replica steps (that IS
        the probe) but receives nothing until the probe closes the
        breaker."""
        return (i in self._live
                and self._breaker[i]["state"] == "closed"
                and i not in self._stalled
                and i not in self._draining)

    def _replica_fault(self, i: int, tick: int, now: float,
                       exc: Exception) -> None:
        """A replica step escaped its engine-level retries.  Count it;
        trip the breaker at the consecutive-failure threshold; a failed
        half-open probe reopens with doubled (bounded) backoff — the
        ``retry_with_backoff`` convention at the step-boundary
        granularity."""
        self.replica_faults += 1
        br = self._breaker[i]
        if self.rec.enabled:
            self.rec.emit(
                "fleet.replica_fault", cat="serve", actor="fleet",
                payload={"replica": i, "fails": br["fails"] + 1,
                         "state": br["state"],
                         "error": type(exc).__name__},
                t=now)
        if br["state"] == "half_open":
            br["state"] = "open"
            br["backoff"] = min(br["backoff"] * 2,
                                self.breaker_max_backoff_ticks)
            br["until"] = tick + 1 + br["backoff"]
            self._reanchor_streams(i, drop_caches=False, now=now)
            self._live.discard(i)
            self.breaker_ejections += 1
            self.generation += 1
            self.timeline.append({
                "generation": self.generation, "tick": tick,
                "kind": "replica_ejected", "replica": i,
                "live": sorted(self._live),
                "signal": self.autoscale_signal()})
            if self.rec.enabled:
                self.rec.emit(
                    "fleet.replica_ejected", cat="serve", actor="fleet",
                    payload={"replica": i, "reason": "probe_failed",
                             "backoff_ticks": br["backoff"]},
                    t=now)
            return
        br["fails"] += 1
        if br["fails"] >= self.breaker_threshold:
            self._eject_replica(i, tick, now)

    def _eject_replica(self, i: int, tick: int, now: float) -> None:
        self.generation += 1
        n = self._reanchor_streams(i, drop_caches=False, now=now)
        br = self._breaker[i]
        br["state"] = "open"
        br["fails"] = 0
        br["until"] = tick + 1 + br["backoff"]
        self._live.discard(i)
        self._draining.discard(i)
        self.breaker_ejections += 1
        self.timeline.append({
            "generation": self.generation, "tick": tick,
            "kind": "replica_ejected", "replica": i,
            "live": sorted(self._live),
            "signal": self.autoscale_signal()})
        if self.rec.enabled:
            self.rec.emit(
                "fleet.replica_ejected", cat="serve", actor="fleet",
                payload={"replica": i, "reason": "launch_failures",
                         "reanchored": n,
                         "backoff_ticks": br["backoff"]},
                t=now)

    def _breaker_tick(self, tick: int, now: float) -> None:
        for i, br in enumerate(self._breaker):
            if br["state"] == "open" and tick >= br["until"]:
                br["state"] = "half_open"
                self._live.add(i)
                self.breaker_probes += 1
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.replica_probe", cat="serve", actor="fleet",
                        payload={"replica": i,
                                 "backoff_ticks": br["backoff"]},
                        t=now)

    def _breaker_close(self, i: int, tick: int, now: float) -> None:
        """A half-open probe tick completed without raising: close the
        breaker, reset the backoff, and let the router see the replica
        again."""
        br = self._breaker[i]
        br["state"] = "closed"
        br["fails"] = 0
        br["backoff"] = self.breaker_backoff_ticks
        self.breaker_recoveries += 1
        self.generation += 1
        self.timeline.append({
            "generation": self.generation, "tick": tick,
            "kind": "replica_recovered", "replica": i,
            "live": sorted(self._live),
            "signal": self.autoscale_signal()})
        if self.rec.enabled:
            self.rec.emit(
                "fleet.replica_recovered", cat="serve", actor="fleet",
                payload={"replica": i, "via": "probe"},
                t=now)

    # ---- the closed autoscale loop ---------------------------------------

    def _apply_autoscale(self, tick: int, now: float) -> None:
        """Act on :meth:`autoscale_policy` (``apply_autoscale=True``):
        scale-up re-admits a provisioned cold replica (its engine and
        graphs already built) or cancels an in-progress drain;
        scale-down marks a graceful-drain victim — routing stops, its
        residents migrate or finish, and only then is it removed.  One
        replica per application, never below one routable replica,
        never a dropped stream."""
        pol = self.autoscale_policy(**self.autoscale_params)
        target = pol["target_replicas"]
        live = len(self._live)
        if target > live:
            if self._draining:
                idx = max(self._draining)
                self._draining.discard(idx)
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.autoscale", cat="serve", actor="fleet",
                        payload={"action": "undrain", "replica": idx,
                                 "target": target},
                        t=now)
                return
            cands = [i for i in range(len(self.engines))
                     if i not in self._live
                     and self._breaker[i]["state"] == "closed"
                     and i not in self._stalled]
            if not cands:
                return
            idx = cands[0]
            self._live.add(idx)
            self.autoscale_added += 1
            self.generation += 1
            self.timeline.append({
                "generation": self.generation, "tick": tick,
                "kind": "autoscale_add", "replica": idx,
                "live": sorted(self._live),
                "signal": pol["signal"]})
            if self.rec.enabled:
                self.rec.emit(
                    "fleet.autoscale", cat="serve", actor="fleet",
                    payload={"action": "add", "replica": idx,
                             "target": target,
                             "live": sorted(self._live)},
                    t=now)
        elif target < live:
            cands = [i for i in sorted(self._live)
                     if self._routable(i)]
            if len(cands) <= 1:
                return
            victim = min(cands, key=lambda i: (self._load(i), -i))
            self._draining.add(victim)
            self.generation += 1
            self.timeline.append({
                "generation": self.generation, "tick": tick,
                "kind": "autoscale_drain", "replica": victim,
                "live": sorted(self._live),
                "signal": pol["signal"]})
            if self.rec.enabled:
                self.rec.emit(
                    "fleet.autoscale", cat="serve", actor="fleet",
                    payload={"action": "drain", "replica": victim,
                             "target": target},
                    t=now)

    def _drain_tick(self, tick: int, now: float) -> None:
        """Advance every graceful drain: replica-queued work re-anchors
        to the fleet (it re-routes), decode-phase residents migrate
        with their KV when an adoptable target has room, everything
        else finishes in place; the moment the replica is empty it is
        retired."""
        for idx in sorted(self._draining):
            eng = self.engines[idx]
            sd = eng.sched
            for r in list(sd.queue):
                record = self._stamp_handoff(
                    eng.export_stream(r.rid, with_kv=False))
                ent = self._ledger.get(int(r.rid))
                if ent is not None:
                    ent["owner"] = None
                self._insert_handoffs(
                    [_Item(req=self._record_req(record), record=record)],
                    now)
            ready = sorted(
                (s for s in sd.slots
                 if s is not None and s.phase == "decode"
                 and s.written >= 1 and s.budget > 0),
                key=lambda s: s.admitted_seq)
            for s in ready:
                n_blocks = len(sd.migratable_blocks(s.rid))
                if not n_blocks:
                    continue
                has_target = any(
                    self.roles[j] != "prefill"
                    and self.engines[j].store is not None
                    and self._store_room(j) >= n_blocks
                    for j in self._live
                    if j != idx and self._routable(j))
                if not has_target:
                    continue
                t0 = time.perf_counter()
                record = eng.export_stream(s.rid, with_kv=True)
                self.migration_secs += time.perf_counter() - t0
                self.migrations += 1
                self.migration_bytes += int(record["payload_bytes"])
                self.migrated_rids.append(int(record["rid"]))
                self._stamp_handoff(record)
                ent = self._ledger.get(int(record["rid"]))
                if ent is not None:
                    ent["owner"] = None
                self._insert_handoffs(
                    [_Item(req=self._record_req(record), record=record)],
                    now)
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.migrate", cat="serve", actor="fleet",
                        payload={"rid": int(record["rid"]),
                                 "from": idx, "blocks": n_blocks,
                                 "bytes": int(record["payload_bytes"]),
                                 "reason": "drain"},
                        t=now)
            if not sd.has_resident and not sd.queue:
                self._draining.discard(idx)
                self._live.discard(idx)
                self.autoscale_retired += 1
                self.generation += 1
                self.timeline.append({
                    "generation": self.generation, "tick": tick,
                    "kind": "autoscale_retired", "replica": idx,
                    "live": sorted(self._live),
                    "signal": self.autoscale_signal()})
                if self.rec.enabled:
                    self.rec.emit(
                        "fleet.autoscale", cat="serve", actor="fleet",
                        payload={"action": "retired", "replica": idx,
                                 "live": sorted(self._live)},
                        t=now)

    # ---- fleet snapshot / restore ----------------------------------------

    @staticmethod
    def _ser_record(record: dict) -> dict:
        """A queue record as JSON: numpy -> lists, payloads STRIPPED —
        KV bytes are never persisted, so a restored record re-enters as
        a re-prefill continuation (positions make that bitwise-safe)."""
        out = dict(record)
        out["prompt"] = [int(t) for t in record["prompt"]]
        out["replay"] = [int(t) for t in record.get("replay", ())]
        out["rng"] = [int(x) for x in np.asarray(record["rng"]).ravel()]
        out["payloads"] = []
        out["payload_bytes"] = 0
        return out

    def _ser_item(self, item: _Item) -> dict:
        if item.record is not None:
            return {"record": self._ser_record(item.record)}
        r = item.req
        return {"req": {
            "rid": int(r.rid),
            "prompt": [int(t) for t in r.prompt],
            "max_new_tokens": int(r.max_new_tokens),
            "rng": [int(x) for x in np.asarray(r.rng).ravel()],
            "arrival": float(r.arrival),
            "ttft_deadline_s": r.ttft_deadline_s,
            "deadline_s": r.deadline_s,
            "tenant": int(r.tenant), "adapter": int(r.adapter)}}

    @staticmethod
    def _deser_item(d: dict) -> _Item:
        if "record" in d:
            rec = dict(d["record"])
            rec["prompt"] = np.asarray(rec["prompt"], np.int32)
            rec["rng"] = np.asarray(rec["rng"], np.uint32)
            rec["payloads"] = []
            rec["payload_bytes"] = 0
            return _Item(req=FleetScheduler._record_req(rec), record=rec)
        q = dict(d["req"])
        return _Item(req=Request(
            rid=int(q["rid"]),
            prompt=np.asarray(q["prompt"], np.int32),
            max_new_tokens=int(q["max_new_tokens"]),
            rng=np.asarray(q["rng"], np.uint32),
            arrival=float(q["arrival"]),
            ttft_deadline_s=q["ttft_deadline_s"],
            deadline_s=q["deadline_s"],
            tenant=int(q["tenant"]), adapter=int(q["adapter"])))

    def save_snapshot(self, *, async_: bool = False) -> int | None:
        """Serialize the WHOLE fleet through the manifested /
        CRC-verified checkpointer as one uint8 JSON blob: the global
        queue (payloads stripped — KV is never persisted), DRR deficits,
        tenant counters, the admission ledger, adoption/breaker/stall/
        drain/autoscale state, the graveyard, and every replica's
        engine-level snapshot dict.  Restore rebuilds every resident's
        cache from its recorded position (in the replicas' continuations
        form), so each in-flight stream finishes bitwise vs the
        uninterrupted run.  Returns the snapshot label,
        or None if the save was skipped."""
        if self._ckpt is None:
            raise ValueError(
                "FleetScheduler(snapshot_dir=...) not configured")
        state = {
            "tick": self._tick,
            "queue": [self._ser_item(it) for it in self.queue],
            "deficit": {str(t): int(v)
                        for t, v in self._deficit.items()},
            "fleet_tenants": {str(t): dict(c) for t, c in
                              self._fleet_tenants.items()},
            "counters": {
                "shed": self.shed, "migrations": self.migrations,
                "migration_bytes": self.migration_bytes,
                "migration_secs": self.migration_secs,
                "prefix_route_hits": self.prefix_route_hits,
                "prefix_route_hit_tokens": self.prefix_route_hit_tokens,
                "generation": self.generation,
                "replicas_shed": self.replicas_shed,
                "replicas_regrown": self.replicas_regrown,
                "replica_crashes": self.replica_crashes,
                "replica_stalls": self.replica_stalls,
                "breaker_ejections": self.breaker_ejections,
                "breaker_probes": self.breaker_probes,
                "breaker_recoveries": self.breaker_recoveries,
                "replica_faults": self.replica_faults,
                "migration_dups_dropped": self.migration_dups_dropped,
                "autoscale_added": self.autoscale_added,
                "autoscale_retired": self.autoscale_retired,
            },
            "migrated_rids": list(self.migrated_rids),
            "adopted": sorted(list(p) for p in self._adopted),
            "handoff_seq": self._handoff_seq,
            "ledger_seq": self._ledger_seq,
            "torn_pending": self._torn_pending,
            "ledger": {str(rid): {
                **{k: ent[k] for k in
                   ("seq", "replay", "budget", "arrival", "tenant",
                    "adapter", "emitted_prior", "first_emit_prior", "meta",
                    "since", "owner", "done")},
                "prompt": [int(t) for t in ent["prompt"]],
                "rng": [int(x) for x in
                        np.asarray(ent["rng"]).ravel()],
            } for rid, ent in self._ledger.items()},
            "live": sorted(self._live),
            "stalled": {str(i): t for i, t in self._stalled.items()},
            "draining": sorted(self._draining),
            "breaker": [dict(b) for b in self._breaker],
            "scale": [self._scale_direction, self._scale_streak],
            "timeline": list(self.timeline),
            "grave": {
                "completions": {str(r): toks for r, toks in
                                self._grave_completions.items()},
                "tenants": {str(t): dict(c) for t, c in
                            self._grave_tenants.items()},
                "counters": dict(self._grave_counters)},
            "replicas": [{"sched": eng.sched.snapshot_state(),
                          "tick": eng._tick,
                          "steps": dict(eng.steps)}
                         for eng in self.engines],
        }
        blob = np.frombuffer(json.dumps(state).encode("utf-8"),
                             dtype=np.uint8).copy()
        label = max(self._tick, self._last_snap + 1)
        if not self._ckpt.save(label, {"blob": blob}, async_=async_):
            return None
        self._last_snap = label
        if self.rec.enabled:
            self.rec.emit(
                "fleet.snapshot_save", cat="serve", actor="fleet",
                payload={"label": int(label),
                         "queued": len(self.queue),
                         "replicas": len(self.engines),
                         "async": bool(async_)})
        return label

    def restore_latest_snapshot(self) -> int | None:
        """Restore the newest VALID fleet snapshot (the ladder: a
        truncated or CRC-corrupt member is skipped, falling back to the
        next older one) into THIS fleet, which must be fresh and built
        with the same replica count.  Every pool stays zeroed; every
        formerly-resident stream re-enters as a queued continuation and
        re-prefills through normal admission — bitwise identical to an
        uninterrupted run.  Returns the restored label, or None when no
        valid snapshot exists."""
        if self._ckpt is None:
            raise ValueError(
                "FleetScheduler(snapshot_dir=...) not configured")
        got = self._ckpt.restore_latest_valid(None)
        if got is None:
            if self.rec.enabled:
                self.rec.emit("fleet.snapshot_restore_miss", cat="serve",
                              actor="fleet", payload={})
            return None
        tree, label = got
        state = json.loads(
            np.asarray(tree["blob"], np.uint8).tobytes().decode("utf-8"))
        if len(state["replicas"]) != len(self.engines):
            raise ValueError(
                f"snapshot has {len(state['replicas'])} replicas, this "
                f"fleet has {len(self.engines)} — restore needs the "
                "same provisioned width")
        for eng, snap in zip(self.engines, state["replicas"]):
            eng.sched.restore_state(snap["sched"])
            eng._tick = int(snap["tick"])
            for k, v in snap["steps"].items():
                eng.steps[k] = int(v)
        self._tick = int(state["tick"])
        self.queue = [self._deser_item(d) for d in state["queue"]]
        self._deficit = {int(t): int(v)
                         for t, v in state["deficit"].items()}
        self._fleet_tenants = {
            int(t): {k: int(v) for k, v in c.items()}
            for t, c in state["fleet_tenants"].items()}
        c = state["counters"]
        self.shed = int(c["shed"])
        self.migrations = int(c["migrations"])
        self.migration_bytes = int(c["migration_bytes"])
        self.migration_secs = float(c["migration_secs"])
        self.prefix_route_hits = int(c["prefix_route_hits"])
        self.prefix_route_hit_tokens = int(c["prefix_route_hit_tokens"])
        self.generation = int(c["generation"])
        self.replicas_shed = int(c["replicas_shed"])
        self.replicas_regrown = int(c["replicas_regrown"])
        self.replica_crashes = int(c["replica_crashes"])
        self.replica_stalls = int(c["replica_stalls"])
        self.breaker_ejections = int(c["breaker_ejections"])
        self.breaker_probes = int(c["breaker_probes"])
        self.breaker_recoveries = int(c["breaker_recoveries"])
        self.replica_faults = int(c["replica_faults"])
        self.migration_dups_dropped = int(c["migration_dups_dropped"])
        self.autoscale_added = int(c["autoscale_added"])
        self.autoscale_retired = int(c["autoscale_retired"])
        self.migrated_rids = [int(r) for r in state["migrated_rids"]]
        self._adopted = {(int(a), int(b)) for a, b in state["adopted"]}
        self._handoff_seq = int(state["handoff_seq"])
        self._ledger_seq = int(state["ledger_seq"])
        self._torn_pending = int(state["torn_pending"])
        self._ledger = {int(rid): {
            **{k: ent[k] for k in
               ("seq", "replay", "budget", "arrival", "tenant", "adapter",
                "emitted_prior", "first_emit_prior", "meta",
                "since", "owner", "done")},
            "prompt": np.asarray(ent["prompt"], np.int32),
            "rng": np.asarray(ent["rng"], np.uint32),
        } for rid, ent in state["ledger"].items()}
        self._live = set(int(i) for i in state["live"])
        self._stalled = {int(i): int(t)
                         for i, t in state["stalled"].items()}
        self._draining = set(int(i) for i in state["draining"])
        self._breaker = [dict(b) for b in state["breaker"]]
        self._scale_direction, self._scale_streak = (
            int(state["scale"][0]), int(state["scale"][1]))
        self.timeline = list(state["timeline"])
        g = state["grave"]
        self._grave_completions = {
            int(r): [int(t) for t in toks]
            for r, toks in g["completions"].items()}
        self._grave_tenants = {
            int(t): {k: int(v) for k, v in cc.items()}
            for t, cc in g["tenants"].items()}
        self._grave_counters = {k: int(v)
                                for k, v in g["counters"].items()}
        self._last_snap = label
        if self.rec.enabled:
            self.rec.emit(
                "fleet.snapshot_restore", cat="serve", actor="fleet",
                payload={"label": int(label),
                         "queued": len(self.queue)})
        return label

    def autoscale_signal(self) -> dict:
        """What an autoscaler would act on: global queue pressure
        against live capacity, the worst live replica's TTFT-EWMA (the
        engines' shed-gate statistic), and cumulative goodput tokens."""
        live = sorted(self._live)
        queued = len(self.queue) + sum(
            len(self.engines[i].sched.queue) for i in live)
        capacity = max(1, len(live) * self.num_slots)
        ewmas = [self.engines[i]._ttft_ewma for i in live
                 if self.engines[i]._ttft_ewma is not None]
        goodput = sum(c["tokens"]
                      for eng in self.engines
                      for c in eng.sched.tenants.values())
        pressure = queued / capacity
        return {
            "queued": queued,
            "live_replicas": len(live),
            "total_replicas": len(self.engines),
            "pressure": pressure,
            "ttft_ewma_s": max(ewmas) if ewmas else None,
            "goodput_tokens": goodput,
            "want_more_replicas": bool(
                pressure > 1.0 or len(live) < len(self.engines)),
        }

    def autoscale_policy(self, *, min_replicas: int = 1,
                         max_replicas: int | None = None,
                         up_pressure: float = 1.0,
                         down_pressure: float = 0.25,
                         hysteresis: int = 3) -> dict:
        """:meth:`autoscale_signal` -> a target-replica-count
        RECOMMENDATION.  Advisory by default (an external operator is
        one intended consumer); ``apply_autoscale=True`` closes the
        loop — :meth:`_apply_autoscale` acts on the target every
        ``autoscale_every`` ticks, adding a provisioned cold replica or
        retiring one by graceful drain.

        Hysteresis: the signal must lean the same direction for
        ``hysteresis`` consecutive evaluations before the target moves
        off the current live count, and then it moves by ONE replica —
        a flapping queue cannot saw the fleet.  Scale-down additionally
        requires an empty queue (draining capacity under backlog is
        never recommended).  The target is clamped to
        ``[min_replicas, max_replicas]`` (default max: the fleet's
        provisioned width)."""
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        cap = (len(self.engines) if max_replicas is None
               else int(max_replicas))
        if cap < min_replicas:
            raise ValueError(
                f"max_replicas {cap} < min_replicas {min_replicas}")
        sig = self.autoscale_signal()
        live = sig["live_replicas"]
        if sig["pressure"] > up_pressure:
            direction = 1
        elif sig["pressure"] < down_pressure and sig["queued"] == 0:
            direction = -1
        else:
            direction = 0
        if direction != 0 and direction == self._scale_direction:
            self._scale_streak += 1
        else:
            self._scale_direction = direction
            self._scale_streak = 1 if direction else 0
        target = live
        if direction and self._scale_streak >= hysteresis:
            target = live + direction
        target = max(min_replicas, min(cap, target))
        return {
            "target_replicas": target,
            "live_replicas": live,
            "direction": direction,
            "streak": self._scale_streak,
            "hysteresis": hysteresis,
            "min_replicas": min_replicas,
            "max_replicas": cap,
            "signal": sig,
        }

    # ---- the fleet tick --------------------------------------------------

    def step(self, now: float = 0.0) -> tuple[list[Event], str]:
        """One fleet tick: apply due world and fleet faults, advance
        breaker/stall/autoscale/drain state machines, run the global DRR
        dispatch, step every live replica once (an exception escaping a
        replica's own retries becomes a breaker strike, never a fleet
        crash), then migrate any freshly-prefilled streams off
        prefill-role replicas.  Returns (events, kind) with kind in
        {"busy", "idle"} — replica ticks, dispatches, migrations and
        fault handling all count as progress."""
        tick = self._tick
        self._tick += 1
        self._apply_world(tick, now)
        self._apply_fleet_chaos(tick, now)
        self._breaker_tick(tick, now)
        self._stall_tick(tick, now)
        if self.apply_autoscale and tick % self.autoscale_every == 0:
            self._apply_autoscale(tick, now)
        if self._draining:
            self._drain_tick(tick, now)
        dispatched = self._dispatch(now)
        events: list[Event] = []
        busy = dispatched > 0
        # per-replica wall seconds of THIS tick: replicas are independent
        # machines, so a virtual-clock harness should charge the slowest
        # replica (plus the supervisor's own overhead), not the sum the
        # in-process serial loop happens to pay
        self.step_secs: dict[int, float] = {}
        for i in sorted(self._live):
            t0 = time.perf_counter()
            try:
                evs, kind = self.engines[i].step(now)
            except Exception as e:  # noqa: BLE001 — breaker's strike zone
                self.step_secs[i] = time.perf_counter() - t0
                self._replica_fault(i, tick, now, e)
                busy = True
                continue
            self.step_secs[i] = time.perf_counter() - t0
            br = self._breaker[i]
            if br["state"] == "half_open":
                self._breaker_close(i, tick, now)
            elif br["fails"]:
                br["fails"] = 0  # threshold means CONSECUTIVE failures
            self._observe(i, evs)
            events.extend(evs)
            busy = busy or kind != "idle"
        if self.disagg:
            busy = bool(self._migrate_prefilled(now)) or busy
        return events, ("busy" if busy else "idle")

    def next_arrival(self) -> float | None:
        """Earliest future arrival anywhere in the fleet — the virtual
        clock's fast-forward target when a tick comes back idle.
        Re-anchored migration records (arrival ``-inf``) never gate."""
        cands = [it.req.arrival for it in self.queue
                 if it.req.arrival != float("-inf")]
        for i in sorted(self._live):
            nxt = self.engines[i].sched.next_arrival()
            if nxt is not None:
                cands.append(nxt)
        return min(cands) if cands else None

    def _has_work(self) -> bool:
        return bool(self.queue) or any(
            self.engines[i].sched.has_queued
            or self.engines[i].sched.has_resident
            for i in sorted(self._live))

    def run(self, max_ticks: int | None = None) -> list[Event]:
        """Drain all submitted work on the tick clock.  Idle ticks are
        tolerated in bounded runs of them (chaos pressure holds and
        pending world returns resolve by tick), then declared a
        deadlock."""
        events: list[Event] = []
        ticks = 0
        stalled = 0
        while self._has_work():
            evs, kind = self.step(now=float("inf"))
            events.extend(evs)
            stalled = 0 if kind != "idle" else stalled + 1
            if stalled > 64:
                raise RuntimeError(
                    "fleet deadlock: work queued but no replica "
                    "progressing")
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        for i in sorted(self._live):
            self.engines[i]._release_pressure(float("inf"))
        return events

    # ---- introspection ---------------------------------------------------

    def completions(self) -> dict[int, list[int]]:
        """rid -> emitted tokens, merged across replicas AND the
        graveyard (streams that finished on a since-crashed engine).
        Disjoint by construction: a stream's emitted list TRAVELS with
        it (popped at detach, installed at attach), so a rid appearing
        on two replicas is a conservation bug worth crashing on."""
        out: dict[int, list[int]] = {}
        for rid, toks in self._grave_completions.items():
            out[int(rid)] = list(toks)
        for eng in self.engines:
            for rid, toks in eng.completions().items():
                if rid in out:
                    raise AssertionError(
                        f"rid {rid} emitted on two replicas — the "
                        "migration seam double-counted a stream")
                out[rid] = toks
        return out

    def health(self) -> dict:
        """Fleet health: per-replica engine healths plus the GLOBAL
        view — element-wise per-tenant aggregation across every replica
        (migration makes this a disjoint sum: submitted once at the
        dispatch replica, terminal status once where the stream ended)
        merged with fleet-door sheds and the graveyard (accounting
        harvested from crashed engines), and the fleet counters."""
        tenants: dict[int, dict[str, int]] = {}
        for eng in self.engines:
            for t, c in eng.sched.tenants.items():
                agg = tenants.setdefault(int(t), {})
                for k, v in c.items():
                    agg[k] = agg.get(k, 0) + int(v)
        for src in (self._fleet_tenants, self._grave_tenants):
            for t, c in src.items():
                agg = tenants.setdefault(int(t), {})
                for k, v in c.items():
                    agg[k] = agg.get(k, 0) + int(v)
        replicas = []
        for i, eng in enumerate(self.engines):
            h = eng.health()
            h["role"] = self.roles[i]
            h["live"] = i in self._live
            h["breaker"] = {k: self._breaker[i][k]
                            for k in ("state", "fails", "backoff")}
            h["stalled"] = i in self._stalled
            h["draining"] = i in self._draining
            replicas.append(h)
        return {
            "replicas": replicas,
            "tenants": {t: dict(c) for t, c in sorted(tenants.items())},
            "queued": len(self.queue),
            "shed": (self.shed + self._grave_counters["shed"]
                     + sum(h["shed"] for h in replicas)),
            "live_replicas": len(self._live),
            "generation": self.generation,
            "replicas_shed": self.replicas_shed,
            "replicas_regrown": self.replicas_regrown,
            "migrations": self.migrations,
            "migration_bytes": self.migration_bytes,
            "migration_secs": self.migration_secs,
            "prefix_route_hits": self.prefix_route_hits,
            "prefix_route_hit_tokens": self.prefix_route_hit_tokens,
            "completed": (self._grave_counters["completed"]
                          + sum(h["completed"] for h in replicas)),
            "replica_crashes": self.replica_crashes,
            "replica_stalls": self.replica_stalls,
            "breaker_ejections": self.breaker_ejections,
            "breaker_probes": self.breaker_probes,
            "breaker_recoveries": self.breaker_recoveries,
            "replica_faults": self.replica_faults,
            "launch_failures": sum(h["launch_failures"]
                                   for h in replicas),
            "migration_dups_dropped": self.migration_dups_dropped,
            "autoscale_added": self.autoscale_added,
            "autoscale_retired": self.autoscale_retired,
            "stalled": sorted(self._stalled),
            "draining": sorted(self._draining),
            "autoscale": self.autoscale_policy(),
        }

    def check_leaks(self) -> None:
        """Joint ledger audit across every replica's pool AND host
        store — shed replicas included (they must have released
        everything on the way out)."""
        for eng in self.engines:
            eng.sched.check_leaks()

    def close(self) -> None:
        for eng in self.engines:
            eng.close()
