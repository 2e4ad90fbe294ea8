"""The port's serving fleet (``serve/fleet.py``) held to the JAX
package's ``tests/test_fleet.py`` and ``tests/test_fleet_chaos.py`` pins
on the CPU, and to the JAX fleet itself on one arrival trace.

Every stream — routed anywhere, migrated prefill -> decode with its KV,
re-anchored through a replica loss, a hard crash, a stall or an
ejection, drained, or restored from a fleet snapshot — must equal the
request's solo run (the port's one-shot generator, which the port engine
equals bitwise on the CPU). The same paths run again in the card's
``"replay"`` continuation form, where a rebuilt stream re-prefills only
its base prompt and feeds its tokens back through decode steps. The
JAX tests' replica-mesh test (each replica on its own DP x TP mesh)
becomes the check that such a replica raises NotImplementedError (ROADMAP
Queue 1 item 3). Geometry: the JAX tests' (vocab 64, 2 layers, 2 heads,
d_model 16, max_len 64, float32), the JAX weights bridged into the port.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import kv_migration_bytes as ref_migration_bytes
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.serve import FleetScheduler as JFleet
from distributed_tensorflow_guide_tpu.serve import Request as JRequest
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    EngineOverloaded,
    Request,
    ServeEngine,
)
from distributed_tensorflow_guide_tpu_torch.serve.fleet import FleetScheduler
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    kv_block_bytes,
    kv_migration_bytes,
)
from distributed_tensorflow_guide_tpu_torch.serve.scheduler import Scheduler
from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
    Fault,
    FaultSchedule,
    corrupt_checkpoint,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny ops: one intra-op thread a worker keeps them from spinning
    against the other test workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=16,
            d_ff=32, max_len=64, causal=True)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
CFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32),
           np.array([1] * 17, np.int32)]
MAX_NEW = [8, 6, 10]
HEAD_DIM = GEOM["d_model"] // GEOM["num_heads"]
FORMS = ["prefill", "replay"]


@pytest.fixture(scope="module")
def jparams():
    return jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def model(jparams):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    m = ttf.Transformer(CFG)
    m.load_state_dict(bridge.params_from_flax(tree, CFG))
    return m.eval()


def _key(i):
    return np.array([0, 100 + i], np.uint32)  # == jax.random.PRNGKey(100+i)


_ORACLES: dict = {}


def _oracle(model, i, temp, top_k, *, prompts=PROMPTS, max_new=MAX_NEW):
    p, mn = prompts[i], max_new[i]
    key = (i, temp, top_k, tuple(p.tolist()), mn)
    if key not in _ORACLES:
        gen = tgen.make_generate_fn(CFG, max_new_tokens=mn,
                                    temperature=temp, top_k=top_k,
                                    device="cpu")
        _ORACLES[key] = gen(model, p[None], _key(i))[0, len(p):].tolist()
    return list(_ORACLES[key])


def _fleet(model, *, temp=0.0, top_k=None, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("slots", 2)
    kw.setdefault("num_blocks", 33)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("device", "cpu")
    return FleetScheduler(CFG, model, temperature=temp, top_k=top_k, **kw)


def _submit_all(fl, rid0=0):
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        fl.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=mn,
                          rng=_key(i), tenant=i % 2))


def _assert_bitwise(fl, model, temp, top_k, rid0=0):
    got = fl.completions()
    for i in range(len(PROMPTS)):
        assert got[rid0 + i] == _oracle(model, i, temp, top_k), \
            f"req {rid0 + i}"


# ---- the acceptance pin, fleet-wide ----------------------------------------


@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_fleet_matches_one_shot_bitwise(model, temp, top_k):
    """Two colocated replicas behind the global DRR door: every stream,
    wherever routed, equals that request's solo run."""
    fl = _fleet(model, temp=temp, top_k=top_k)
    _submit_all(fl)
    events = fl.run()
    _assert_bitwise(fl, model, temp, top_k)
    assert sorted(e.rid for e in events if e.done) == [0, 1, 2]
    h = fl.health()
    assert h["completed"] == 3 and h["queued"] == 0
    assert all(r["completed"] >= 1 for r in h["replicas"])
    sig = fl.autoscale_signal()
    assert sig["goodput_tokens"] == sum(MAX_NEW)
    assert not sig["want_more_replicas"]
    fl.check_leaks()
    fl.close()


@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_disagg_migration_is_bitwise(model, temp, top_k):
    """Disaggregated roles: every stream prefills on the prefill replica,
    ships its KV blocks at the phase flip and finishes on the decode
    replica, bitwise."""
    fl = _fleet(model, temp=temp, top_k=top_k, roles="disagg")
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, temp, top_k)
    assert fl.migrations == 3
    assert sorted(fl.migrated_rids) == [0, 1, 2]
    assert fl.migration_bytes > 0
    roles = {r["role"]: r for r in fl.health()["replicas"]}
    assert roles["prefill"]["migrated_out"] == 3
    assert roles["decode"]["migrated_in"] == 3
    assert roles["prefill"]["completed"] == 0
    assert roles["decode"]["completed"] == 3
    fl.check_leaks()
    fl.close()


def test_fleet_routes_and_completes_as_the_jax_fleet(model):
    """Both packages' 2-replica fleets over the same six requests and
    arrival trace on a virtual clock: the same replica for every rid, the
    same dispatch order, and the same greedy completions."""
    arrivals = [0.0, 0.0, 0.01, 0.02, 0.02, 0.05]
    prompts = PROMPTS + [PROMPTS[0][::-1].copy(), PROMPTS[1][:6].copy(),
                         PROMPTS[2][:3].copy()]
    max_new = MAX_NEW + [5, 7, 4]
    kw = dict(replicas=2, slots=2, num_blocks=33, block_size=8,
              prefill_chunk=8, temperature=0.0, top_k=None)
    # the JAX fleet's per-replica weights, bridged from the port's model
    jfl = JFleet(JCFG, bridge.fleet_params_to_flax(model.state_dict(), CFG,
                                                  2), **kw)
    fl = FleetScheduler(CFG, model, device="cpu", **kw)
    for i, (p, mn, t) in enumerate(zip(prompts, max_new, arrivals)):
        jfl.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn,
                            rng=jax.random.PRNGKey(100 + i), arrival=t,
                            tenant=i % 2))
        fl.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i),
                          arrival=t, tenant=i % 2))
    now = 0.0
    while jfl._has_work() or fl._has_work():
        jfl.step(now)
        fl.step(now)
        now += 0.01

    def homes(f):
        return {rid: i for i, eng in enumerate(f.engines)
                for rid in eng.completions()}

    def order(f):
        return sorted(f._ledger, key=lambda r: f._ledger[r]["seq"])

    assert homes(fl) == homes(jfl)
    assert order(fl) == order(jfl)
    assert fl.completions() == jfl.completions()
    assert set(homes(fl).values()) == {0, 1}
    fl.check_leaks()
    fl.close()
    jfl.close()


# ---- chaos: storms at both roles, replica loss / regrow --------------------


def test_migration_under_chaos_zero_dropped_streams(model):
    """Serve faults firing at both roles (launch failures and pool
    pressure): zero dropped streams, every completion bitwise."""
    chaos = [
        FaultSchedule([Fault("serve_step_exception", 2),
                       Fault("pool_pressure", 4, 4.0)]),
        FaultSchedule([Fault("serve_step_exception", 3),
                       Fault("pool_pressure", 6, 4.0)]),
    ]
    fl = _fleet(model, temp=0.8, top_k=10, roles="disagg", chaos=chaos)
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, 0.8, 10)
    for c in chaos:
        assert c.serve_events() == []
        assert len(c.fired) == 2
    assert fl.migrations >= 1
    fl.check_leaks()
    fl.close()


@pytest.mark.parametrize("form", FORMS)
def test_replica_loss_and_regrow_keeps_streams_and_drr(model, form):
    """A ``slice_loss`` mid-flight sheds a replica (its live streams
    re-anchor and rebuild elsewhere, KV lost with it), a later
    ``slice_return`` reabsorbs it cold: every stream bitwise, the global
    per-tenant ledger a conserved disjoint sum."""
    world = FaultSchedule([Fault("slice_loss", 2, 1.0),
                           Fault("slice_return", 6, 1.0)])
    fl = _fleet(model, world_chaos=world, continuations=form)
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, 0.0, None)
    assert world.world_events() == []
    h = fl.health()
    assert h["replicas_shed"] == 1 and h["replicas_regrown"] == 1
    assert h["generation"] == 2 and h["live_replicas"] == 2
    assert [t["kind"] for t in fl.timeline] == ["slice_loss",
                                                "slice_return"]
    assert fl.timeline[0]["signal"]["want_more_replicas"]
    assert h["tenants"][0]["submitted"] == 2 == h["tenants"][0]["done"]
    assert h["tenants"][1]["submitted"] == 1 == h["tenants"][1]["done"]
    assert fl._deficit == {}
    fl.check_leaks()
    fl.close()


def test_tenant_conservation_through_migration(model):
    """health()'s tenant aggregation is a disjoint sum across replicas:
    submitted == done per tenant though every stream submitted on the
    prefill replica and finished on the decode replica, and each
    migration is one source-side preemption."""
    fl = _fleet(model, roles="disagg")
    _submit_all(fl)
    fl.run()
    h = fl.health()
    for t, c in h["tenants"].items():
        assert c["submitted"] == c["done"], f"tenant {t}: {c}"
        assert c["shed"] == c["cancelled"] == c["expired"] == 0
    assert sum(c["submitted"] for c in h["tenants"].values()) == 3
    assert sum(c["preempted"]
               for c in h["tenants"].values()) == fl.migrations == 3
    fl.check_leaks()
    fl.close()


def test_fleet_door_sheds_retriably(model):
    """The global queue-depth gate: the overflow submit raises
    EngineOverloaded with nothing recorded, the shed counts fleet-side
    under its tenant, and the later resubmit completes bitwise."""
    fl = _fleet(model, max_queue=2)
    fl.submit(Request(rid=0, prompt=PROMPTS[0], max_new_tokens=MAX_NEW[0],
                      rng=_key(0), tenant=0))
    fl.submit(Request(rid=1, prompt=PROMPTS[1], max_new_tokens=MAX_NEW[1],
                      rng=_key(1), tenant=1))
    req2 = Request(rid=2, prompt=PROMPTS[2], max_new_tokens=MAX_NEW[2],
                   rng=_key(2), tenant=0)
    with pytest.raises(EngineOverloaded):
        fl.submit(req2)
    assert fl.shed == 1
    fl.run()
    fl.submit(req2)
    fl.run()
    _assert_bitwise(fl, model, 0.0, None)
    h = fl.health()
    assert h["shed"] == 1
    assert h["tenants"][0]["shed"] == 1
    assert h["tenants"][0]["submitted"] == 2
    fl.check_leaks()
    fl.close()


def test_prefix_routing_routes_to_warm_replica(model):
    """A request sharing a cached prefix routes to the replica holding
    it, not the least-loaded one, and the shared blocks stay bitwise."""
    sys_p = (np.arange(16, dtype=np.int32) % 61) + 1
    prompts = [np.concatenate([sys_p, np.array([33, 34, 35, 36],
                                               np.int32)]),
               np.concatenate([sys_p, np.array([40, 41, 42, 43],
                                               np.int32)])]
    max_new = [6, 6]
    fl = _fleet(model, prefix_cache=True)
    fl.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=6,
                      rng=_key(0)))
    fl.run()
    assert fl.prefix_route_hits == 0
    fl.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=6,
                      rng=_key(1)))
    fl.run()
    assert fl.prefix_route_hits == 1
    assert fl.prefix_route_hit_tokens >= 8
    homes = [[i for i, eng in enumerate(fl.engines)
              if rid in eng.completions()] for rid in (0, 1)]
    assert homes[0] == homes[1] and len(homes[0]) == 1
    for i in (0, 1):
        assert fl.completions()[i] == _oracle(model, i, 0.0, None,
                                              prompts=prompts,
                                              max_new=max_new)
    fl.check_leaks()
    fl.close()


def test_migration_bytes_match_closed_form(model):
    """``migration_bytes`` equals the port's closed form (blocks x one
    block's payload, the JAX package's closed form too at this shape)
    and the decode side's swap-in traffic."""
    fl = _fleet(model, roles="disagg")
    _submit_all(fl)
    fl.run()
    mb = fl.migration_bytes
    per = kv_block_bytes(CFG, 8)
    assert mb > 0 and mb % per == 0
    n_blocks = mb // per
    assert mb == kv_migration_bytes(n_blocks, CFG, 8) == ref_migration_bytes(
        n_blocks, GEOM["num_layers"], GEOM["num_heads"], 8, HEAD_DIM,
        activation_dtype_bytes=4)
    decode = [r for r in fl.health()["replicas"] if r["role"] == "decode"]
    assert sum(r["spill_in_blocks"] for r in decode) == n_blocks
    assert sum(r["spill_h2d_bytes"] for r in decode) == mb
    fl.check_leaks()
    fl.close()


def test_fleet_config_validation(model):
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        _fleet(model, replicas=0)
    with pytest.raises(ValueError, match="disagg needs >= 2"):
        _fleet(model, replicas=1, roles="disagg")
    with pytest.raises(ValueError, match="come as a pair"):
        _fleet(model, replicas=2, roles=["prefill", "prefill"])
    with pytest.raises(ValueError, match="roles length"):
        _fleet(model, replicas=2, roles=["colocated"])
    with pytest.raises(ValueError, match="unknown role"):
        _fleet(model, replicas=2, roles=["colocated", "verifier"])
    with pytest.raises(ValueError, match="prefix_routing needs"):
        _fleet(model, prefix_routing=True)
    with pytest.raises(ValueError, match="model list length"):
        FleetScheduler(CFG, [model], replicas=2, slots=2, num_blocks=33,
                       block_size=8, prefill_chunk=8, device="cpu")
    fl = _fleet(model)
    with pytest.raises(ValueError, match="empty prompt"):
        fl.submit(Request(rid=0, prompt=np.array([], np.int32),
                          max_new_tokens=4, rng=_key(0)))
    with pytest.raises(ValueError, match="out of vocabulary"):
        fl.submit(Request(rid=0, prompt=np.array([99], np.int32),
                          max_new_tokens=4, rng=_key(0)))
    with pytest.raises(ValueError, match="exceeds max_len"):
        fl.submit(Request(rid=0, prompt=PROMPTS[2], max_new_tokens=63,
                          rng=_key(0)))
    fl.close()


def test_autoscale_policy_hysteresis_bounds_and_health(model):
    """The advisory target moves by one only after ``hysteresis``
    same-direction evaluations, clamps to [min, max], and never touches
    the live set; surfaced in health()."""
    fl = _fleet(model)
    p = fl.autoscale_policy()
    assert p["direction"] == -1 and p["streak"] == 1
    assert p["target_replicas"] == 2
    assert fl.autoscale_policy()["target_replicas"] == 2
    p = fl.autoscale_policy()
    assert p["streak"] == 3 and p["target_replicas"] == 1
    assert fl.autoscale_policy(min_replicas=2)["target_replicas"] == 2
    for i in range(9):
        fl.submit(Request(rid=100 + i, prompt=PROMPTS[0], max_new_tokens=4,
                          rng=np.array([0, i], np.uint32)))
    p = fl.autoscale_policy()
    assert p["direction"] == 1 and p["streak"] == 1
    assert p["target_replicas"] == 2
    fl.autoscale_policy()
    assert fl.autoscale_policy()["target_replicas"] == 2
    p = fl.autoscale_policy(max_replicas=4)
    assert p["target_replicas"] == 3
    assert p["signal"]["pressure"] > 1.0
    assert len(fl._live) == 2
    h = fl.health()
    assert h["autoscale"]["target_replicas"] >= 2
    assert h["autoscale"]["signal"]["queued"] == 9
    with pytest.raises(ValueError, match="min_replicas"):
        fl.autoscale_policy(min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        fl.autoscale_policy(min_replicas=2, max_replicas=1)
    fl.run()
    fl.check_leaks()
    fl.close()


# ---- fleet under fire: crash, stall, torn handoff, breaker -----------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_fleet_bitwise_under_crash_stall_torn(model, temp, top_k, form):
    """Replica 0 hard-crashes at tick 3 with a torn migration armed,
    replica 1 stalls at tick 6: every stream still equals its solo run.
    The crash path is the real one: the engine object is closed and
    REPLACED, and its residents are rebuilt from the fleet's admission
    ledger alone (in ``form``)."""
    fc = FaultSchedule([Fault("replica_crash", 3, 0.0),
                        Fault("migration_torn", 3),
                        Fault("replica_stall", 6, 1.0)])
    fl = _fleet(model, temp=temp, top_k=top_k, fleet_chaos=fc,
                continuations=form)
    eng0 = fl.engines[0]
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, temp, top_k)
    assert fl.engines[0] is not eng0 and eng0.pool is None  # closed
    assert fl.engines[0].sched.continuations == form
    h = fl.health()
    assert h["replica_crashes"] == 1
    assert h["replica_stalls"] == 1
    assert h["migration_dups_dropped"] == 1
    assert h["breaker_probes"] >= 1 and h["breaker_recoveries"] >= 1
    assert all(r["breaker"]["state"] == "closed" for r in h["replicas"])
    assert h["stalled"] == [] and h["completed"] == 3
    assert fc.fleet_events() == []
    fl.check_leaks()
    fl.close()


@pytest.mark.parametrize("form", FORMS)
def test_torn_migration_adopted_exactly_once(model, form):
    """Disagg roles with a torn handoff armed: the duplicate record
    carries the same handoff id and dispatch drops it — three migrations,
    one duplicate dropped, per-tenant conservation intact."""
    fc = FaultSchedule([Fault("migration_torn", 1)])
    fl = _fleet(model, roles="disagg", fleet_chaos=fc, continuations=form)
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, 0.0, None)
    h = fl.health()
    assert fl.migrations == 3 and sorted(fl.migrated_rids) == [0, 1, 2]
    assert h["migration_dups_dropped"] == 1
    assert all(c["submitted"] == c["done"] for c in h["tenants"].values())
    fl.check_leaks()
    fl.close()


def test_double_residency_crashes_completions(model):
    """A rid whose tokens sit on two replicas (here the graveyard and a
    live engine) must crash ``completions()``, not merge silently."""
    fl = _fleet(model)
    _submit_all(fl)
    fl.run()
    fl._grave_completions[0] = list(fl.completions()[0])
    with pytest.raises(AssertionError, match="two replicas"):
        fl.completions()
    fl.close()


@pytest.mark.parametrize("form", FORMS)
def test_breaker_eject_half_open_recover(model, form):
    """Two escaped step exceptions on replica 0 trip its breaker
    (threshold 2): ejected with its streams re-anchored, probed
    half-open, recovered — every stream bitwise."""
    chaos0 = FaultSchedule([Fault("serve_step_exception", 1),
                            Fault("serve_step_exception", 2)])
    fl = _fleet(model, chaos=[chaos0, None], breaker_threshold=2,
                breaker_backoff_ticks=2, continuations=form)
    for eng in fl.engines:
        eng.retry_attempts = 1  # injected exceptions escape step()
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, 0.0, None)
    h = fl.health()
    assert h["replica_faults"] == 2
    assert h["breaker_ejections"] == 1
    assert h["breaker_probes"] >= 1
    assert h["breaker_recoveries"] == 1
    assert h["launch_failures"] >= 2
    assert all(r["breaker"]["state"] == "closed" for r in h["replicas"])
    fl.check_leaks()
    fl.close()


def test_stall_recovery_rejoins_routing(model):
    """A stalled replica detaches orderly, sits out
    ``stall_recovery_ticks`` excluded from routing, and rejoins with its
    caches warm (the engine object is kept)."""
    fc = FaultSchedule([Fault("replica_stall", 2, 0.0)])
    fl = _fleet(model, fleet_chaos=fc, stall_recovery_ticks=2)
    eng0 = fl.engines[0]
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, 0.0, None)
    h = fl.health()
    assert h["replica_stalls"] == 1 and h["stalled"] == []
    assert fl.engines[0] is eng0
    kinds = [t["kind"] for t in fl.timeline]
    assert "replica_stall" in kinds and "replica_recovered" in kinds
    fl.check_leaks()
    fl.close()


# ---- fleet snapshot / restore ----------------------------------------------


def _emit_until(fl, stop_tokens):
    emitted = 0
    while emitted < stop_tokens:
        evs, _ = fl.step(now=float("inf"))
        emitted += sum(1 for e in evs if e.status == "ok" and e.token >= 0)
    return emitted


@pytest.mark.parametrize("form", FORMS)
def test_snapshot_restore_bitwise_through_crash_and_torn(model, tmp_path,
                                                         form):
    """Kill the fleet at a third of its tokens, after a hard crash and a
    torn migration fired; snapshot, restore on a fresh fleet, finish:
    every stream bitwise, the storm counters carried by the snapshot."""
    total = sum(MAX_NEW)
    fc = FaultSchedule([Fault("replica_crash", 2, 1.0),
                        Fault("migration_torn", 2)])
    fl = _fleet(model, temp=0.8, top_k=10, fleet_chaos=fc,
                snapshot_dir=tmp_path, continuations=form)
    _submit_all(fl)
    _emit_until(fl, total // 3)
    assert fl.replica_crashes == 1
    label = fl.save_snapshot()
    assert label is not None
    fl.close()
    fl2 = _fleet(model, temp=0.8, top_k=10, snapshot_dir=tmp_path,
                 continuations=form)
    assert fl2.restore_latest_snapshot() == label
    fl2.run()
    _assert_bitwise(fl2, model, 0.8, 10)
    h = fl2.health()
    assert h["replica_crashes"] == 1
    assert h["migration_dups_dropped"] == 1
    assert all(c["submitted"] == c["done"] for c in h["tenants"].values())
    fl2.check_leaks()
    fl2.close()


def test_corrupt_fleet_snapshot_ladders_to_previous(model, tmp_path):
    """A truncated newest fleet snapshot: restore ladders to the previous
    committed one and the run still finishes bitwise."""
    total = sum(MAX_NEW)
    fl = _fleet(model, snapshot_dir=tmp_path)
    _submit_all(fl)
    _emit_until(fl, total // 3)
    first = fl.save_snapshot()
    fl.step(now=float("inf"))
    fl.step(now=float("inf"))
    second = fl.save_snapshot()
    assert second > first
    fl.close()
    corrupt_checkpoint(tmp_path, mode="truncate")
    fl2 = _fleet(model, snapshot_dir=tmp_path)
    assert fl2.restore_latest_snapshot() == first
    fl2.run()
    _assert_bitwise(fl2, model, 0.0, None)
    fl2.check_leaks()
    fl2.close()


def test_restore_empty_dir_returns_none(model, tmp_path):
    fl = _fleet(model, snapshot_dir=tmp_path)
    assert fl.restore_latest_snapshot() is None
    fl.close()


def test_autoscale_drain_down_then_add_conserves_streams(model):
    """Scale-down is a graceful drain (routing stops, queued work
    re-anchors, residents migrate or finish, only an empty replica
    retires); scale-up re-admits it under pressure — zero dropped
    streams and per-tenant submitted == done across both."""
    fl = _fleet(model, apply_autoscale=True, autoscale_every=1,
                autoscale_params={"hysteresis": 2, "down_pressure": 2.0})
    _submit_all(fl)
    fl.run()
    h = fl.health()
    assert h["autoscale_retired"] == 1 and h["live_replicas"] == 1
    _assert_bitwise(fl, model, 0.0, None)
    fl.autoscale_params.update(
        {"hysteresis": 1, "up_pressure": 0.0, "down_pressure": -1.0})
    _submit_all(fl, rid0=100)
    _submit_all(fl, rid0=200)
    fl.run()
    h = fl.health()
    assert h["autoscale_added"] >= 1 and h["live_replicas"] == 2
    _assert_bitwise(fl, model, 0.0, None, rid0=100)
    _assert_bitwise(fl, model, 0.0, None, rid0=200)
    assert all(c["submitted"] == c["done"] for c in h["tenants"].values())
    assert sum(c["done"] for c in h["tenants"].values()) == 9
    fl.check_leaks()
    fl.close()


def test_replica_meshes_wait_for_item_3(model):
    """A replica on its own mesh of several devices (the JAX tests' DP x
    TP replicas) is not ported: it raises, naming the ROADMAP item; a
    per-replica list of single devices builds."""
    with pytest.raises(NotImplementedError, match="item 3"):
        _fleet(model, replicas=[("cpu", "cpu"), ("cpu", "cpu")])
    fl = _fleet(model, replicas=["cpu", ("cpu",)])
    assert len(fl.engines) == 2
    _submit_all(fl)
    fl.run()
    _assert_bitwise(fl, model, 0.0, None)
    fl.check_leaks()
    fl.close()


# ---- the continuation form travels with the record -------------------------


def test_prefill_record_refused_by_a_replay_engine(model):
    """A record carries its form; a ``"prefill"`` record adopted by a
    ``"replay"`` engine (or the other way round) raises instead of being
    converted, and a record without a form (the JAX engine's) counts as
    ``"prefill"``."""
    rec = Scheduler.continuation_record(
        rid=5, prompt=np.concatenate([PROMPTS[0], [7, 8]]), budget=4,
        rng=_key(0), emitted=[7, 8])
    assert rec["form"] == "prefill"
    replay_eng = ServeEngine(CFG, model, slots=2, num_blocks=33,
                             block_size=8, prefill_chunk=8, device="cpu",
                             continuations="replay")
    with pytest.raises(ValueError, match="'prefill' continuation record"):
        replay_eng.adopt_stream(rec)
    legacy = dict(rec)
    del legacy["form"]
    with pytest.raises(ValueError, match="'prefill' continuation record"):
        replay_eng.adopt_stream(legacy)
    rrec = Scheduler.continuation_record(
        rid=6, prompt=PROMPTS[0], replay=[7, 8], budget=4, rng=_key(0),
        emitted=[7, 8])
    assert rrec["form"] == "replay"
    prefill_eng = ServeEngine(CFG, model, slots=2, num_blocks=33,
                              block_size=8, prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="'replay' continuation record"):
        prefill_eng.adopt_stream(rrec)
    replay_eng.adopt_stream(rrec)
    prefill_eng.adopt_stream(legacy)
    for eng in (replay_eng, prefill_eng):
        eng.run()
        eng.close()
        eng.sched.check_leaks()


@pytest.mark.parametrize("path", ["with_kv", "reanchor", "crash_rebuild"])
def test_replay_form_migration_paths_are_bitwise(model, path):
    """Each way a stream leaves a replica mid-decode, in the card's
    ``"replay"`` form: exported with its KV (resumed by swap-in),
    re-anchored without it (the base prompt re-prefilled, emitted tokens
    fed back through decode steps), and rebuilt after a hard crash from
    the supervisor's ledger — each finishes bitwise the uninterrupted
    engine's stream."""
    kw = dict(slots=2, num_blocks=33, block_size=8, prefill_chunk=8,
              temperature=0.8, top_k=10, device="cpu",
              continuations="replay", host_blocks=8)
    src = ServeEngine(CFG, model, **kw)
    src.submit(Request(rid=2, prompt=PROMPTS[2], max_new_tokens=MAX_NEW[2],
                       rng=_key(2)))
    for _ in range(7):  # 3 prefill chunks, then 4 decode steps
        src.step()
    emitted = list(src.completions()[2])
    assert 2 <= len(emitted) < MAX_NEW[2]
    if path == "crash_rebuild":
        rec = Scheduler.continuation_record(
            rid=2, prompt=PROMPTS[2], replay=emitted,
            budget=MAX_NEW[2] - len(emitted), rng=_key(2), emitted=emitted)
    else:
        rec = src.export_stream(2, with_kv=path == "with_kv")
        assert rec["form"] == "replay"
        assert bool(rec["payloads"]) == (path == "with_kv")
        assert list(rec["prompt"]) == list(PROMPTS[2])
        assert rec["replay"] == emitted
    dst = ServeEngine(CFG, model, **kw)
    dst.adopt_stream(rec)
    dst.run()
    assert dst.completions()[2] == _oracle(model, 2, 0.8, 10)
    assert dst.sched.spill_resumes == (1 if path == "with_kv" else 0)
    assert dst.steps["prefill"] == (0 if path == "with_kv" else 3)
    for eng in (src, dst):
        eng.close()
        eng.sched.check_leaks()


@pytest.mark.parametrize("argv", [
    ["--fleet", "2", "--fleet-roles", "disagg"],
    ["--host-blocks", "8", "--num-blocks", "9", "--max-new", "30"]],
    ids=["fleet_disagg", "host_blocks"])
def test_serve_cli_fleet_and_host_blocks(argv, capsys):
    """The serve CLI's ``--fleet`` / ``--fleet-roles`` and ``--host-blocks``
    drive the fleet and the spill tier to a clean leak audit."""
    from distributed_tensorflow_guide_tpu_torch.serve import cli

    cli.main(["--device", "cpu", "--requests", "4", *argv])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("pool.check_leaks(): clean")
    assert out.count(" $ token ") == 4
    if "--fleet" in argv:
        assert "'migrations': 4" in out
    else:
        assert "'spill_resumes': 0" not in out
