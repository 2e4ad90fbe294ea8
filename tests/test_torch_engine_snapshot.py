"""The port engine's snapshots, chaos faults and step deadline
(``serve/engine.py``) held to the JAX package's ``tests/test_serving.py``
pins on the CPU (its tests at lines 615, 649, 684, 1037, 1440 and 1596,
and the storm tests before them).

The oracle is the uninterrupted port engine of the same geometry (the
port's engine equals its one-shot bitwise, ``tests/test_torch_serving.py``):
a killed engine restored from a snapshot, a corrupt newest snapshot the
ladder skips, a launch that fails and retries, a hung launch the
watchdog breaks, pool pressure that forces evictions, each ends with
every stream bitwise the uninterrupted run's; the MoE engine too. One
request's greedy tokens after a kill and restore equal the JAX engine's
from bridged weights. Geometry: vocab 256, 2 layers, d=64, 2 heads.
"""

import dataclasses
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.serve import Request as JRequest
from distributed_tensorflow_guide_tpu.serve import ServeEngine as JServeEngine
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
)
from distributed_tensorflow_guide_tpu_torch.serve.scheduler import Scheduler
from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
    SERVE_KINDS,
    Fault,
    FaultSchedule,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run tiny ops: one intra-op thread a worker keeps them
    from spinning against the other test workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOM = dict(vocab_size=256, num_layers=2, num_heads=2, d_model=64,
            d_ff=128, max_len=64, causal=True)
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
MOE_CFG = dataclasses.replace(TCFG, moe_experts=4, moe_capacity=2)
PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32),
           np.array([1] * 17, np.int32)]
MAX_NEW = [8, 6, 10]
TIGHT_PROMPTS = PROMPTS[:1] + [np.array([2, 4, 6, 8, 10, 12, 14],
                                        np.int32)]
TIGHT_MAX_NEW = [40, 40]
ROOMY = dict(slots=2, num_blocks=33, block_size=8, prefill_chunk=8)
TIGHT = dict(slots=2, num_blocks=9, block_size=8, prefill_chunk=8)
SAMPLED = dict(temperature=0.8, top_k=10)


@pytest.fixture(scope="module")
def model():
    return ttf.Transformer(TCFG).init_weights(0).eval()


@pytest.fixture(scope="module")
def moe_model():
    return ttf.Transformer(MOE_CFG).init_weights(0).eval()


def _key(i):
    return np.array([0, 100 + i], np.uint32)  # == jax.random.PRNGKey(100+i)


def _engine(model, cfg=TCFG, geo=ROOMY, **kw):
    return ServeEngine(cfg, model, device="cpu", **geo, **kw)


def _submit_all(eng, prompts=PROMPTS, max_new=MAX_NEW):
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i)))


_ORACLES: dict = {}


def _oracle(model, cfg=TCFG, geo=ROOMY, prompts=PROMPTS, max_new=MAX_NEW,
            **sampling):
    """The uninterrupted engine's streams (memoised per geometry)."""
    key = (id(model), repr(cfg), tuple(sorted(geo.items())),
           tuple(tuple(p.tolist()) for p in prompts), tuple(max_new),
           tuple(sorted(sampling.items())))
    if key not in _ORACLES:
        eng = _engine(model, cfg, geo, **sampling)
        _submit_all(eng, prompts, max_new)
        eng.run()
        _ORACLES[key] = eng.completions()
        eng.close()
    return _ORACLES[key]


def _kill_and_restore(model, tmp_path, *, cfg=TCFG, geo=ROOMY,
                      prompts=PROMPTS, max_new=MAX_NEW, ticks=7,
                      async_=False, continuations="prefill", **kw):
    kw = {**SAMPLED, **kw, "snapshot_dir": str(tmp_path / "snap")}
    eng = _engine(model, cfg, geo, **kw)
    eng.sched.continuations = continuations
    _submit_all(eng, prompts, max_new)
    for _ in range(ticks):
        eng.step()
    label = eng.save_snapshot(async_=async_)
    assert label is not None
    for _ in range(3):  # progress the kill throws away
        eng.step()
    pre = eng.completions()
    assert any(pre.values())
    eng.close()  # the kill: nothing after the snapshot persists
    eng2 = _engine(model, cfg, geo, **kw)
    eng2.sched.continuations = continuations
    assert eng2.restore_latest_snapshot() == label
    eng2.run()
    got = eng2.completions()
    for rid, toks in pre.items():  # delivered tokens are a prefix
        assert got[rid][:len(toks)] == toks
    eng2.sched.pool.check_leaks()
    assert eng2.live_blocks() == 0
    eng2.close()
    return got


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_engine_kill_restore_resumes_bitwise(model, tmp_path, async_):
    got = _kill_and_restore(model, tmp_path, async_=async_)
    assert got == _oracle(model, **SAMPLED)


@pytest.mark.parametrize("kind", ["snapshot_corrupt", "snapshot_truncate"])
def test_snapshot_ladder_skips_damaged_through_eviction(model, tmp_path,
                                                        kind):
    """The newest snapshot is damaged after its commit; the restore
    ladders down to the previous one and still lands every stream bitwise,
    through the forced-eviction geometry (a preemption and re-prefill)."""
    sched = FaultSchedule([Fault(kind, 24)])
    kw = dict(SAMPLED, snapshot_dir=str(tmp_path / "s"))
    eng = _engine(model, geo=TIGHT, chaos=sched, **kw)
    _submit_all(eng, TIGHT_PROMPTS, TIGHT_MAX_NEW)
    for t in range(26):  # saves at ticks 8, 16, 24; the damage at 24
        eng.step()
        if (t + 1) % 8 == 0:
            eng.save_snapshot()
    assert sched.serve_events() == []
    eng.close()
    eng2 = _engine(model, geo=TIGHT, **kw)
    assert eng2.restore_latest_snapshot() == 16
    eng2.run()
    assert eng2.completions() == _oracle(model, geo=TIGHT,
                                         prompts=TIGHT_PROMPTS,
                                         max_new=TIGHT_MAX_NEW, **SAMPLED)
    assert eng.sched.preemptions + eng2.sched.preemptions >= 1
    eng2.sched.pool.check_leaks()
    eng2.close()


def test_snapshot_restore_with_int8_kv(model, tmp_path):
    cfg = dataclasses.replace(TCFG, kv_dtype="int8")
    geo = dict(ROOMY, num_blocks=17)
    got = _kill_and_restore(model, tmp_path, cfg=cfg, geo=geo,
                            prompts=PROMPTS[:2], max_new=MAX_NEW[:2],
                            ticks=5)
    assert got == _oracle(model, cfg, geo, PROMPTS[:2], MAX_NEW[:2],
                          **SAMPLED)


def test_snapshot_restore_rebuilds_prefix_cache(model, tmp_path):
    """The trie is not in the snapshot: the continuations' re-prefills
    rebuild it, the streams stay bitwise, and a repeat of a prompt after
    the restore hits the rebuilt cache."""
    kw = dict(SAMPLED, prefix_cache=True, snapshot_dir=str(tmp_path / "s"))
    eng = _engine(model, **kw)
    _submit_all(eng)
    for _ in range(7):
        eng.step()
    label = eng.save_snapshot()
    for _ in range(3):
        eng.step()
    eng.close()
    eng2 = _engine(model, **kw)
    assert eng2.restore_latest_snapshot() == label
    eng2.run()
    want = _oracle(model, **SAMPLED)
    assert eng2.completions() == want
    assert eng2.health()["prefix_nodes"] >= 2
    eng2.submit(Request(rid=9, prompt=PROMPTS[2], max_new_tokens=MAX_NEW[2],
                        rng=_key(2)))
    eng2.run()
    assert eng2.completions()[9] == want[2]
    assert eng2.health()["prefill_tokens_saved"] == 16
    eng2.close()
    eng2.sched.pool.check_leaks()


def test_moe_engine_kill_restore_resumes_bitwise(moe_model, tmp_path):
    """The MoE engine restored from a snapshot: residents re-prefill
    through the dropless prefill and every stream ends bitwise the
    uninterrupted MoE engine's."""
    got = _kill_and_restore(moe_model, tmp_path, cfg=MOE_CFG)
    assert got == _oracle(moe_model, MOE_CFG, **SAMPLED)


def test_restored_greedy_tokens_equal_the_jax_engine(tmp_path):
    """One request, greedy, killed and restored mid-decode: its tokens
    equal the JAX engine's uninterrupted run from bridged weights."""
    jcfg = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
    jparams = jtf.Transformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    m = ttf.Transformer(TCFG)
    m.load_state_dict(bridge.params_from_flax(
        jax.tree.map(np.asarray, fnn.meta.unbox(jparams)), TCFG))
    m.eval()
    jeng = JServeEngine(jcfg, jparams, temperature=0.0, top_k=None, **ROOMY)
    jeng.submit(JRequest(rid=0, prompt=PROMPTS[1], max_new_tokens=12,
                         rng=jax.random.PRNGKey(100)))
    jeng.run()
    got = _kill_and_restore(m, tmp_path, prompts=PROMPTS[1:2],
                            max_new=[12], ticks=4, temperature=0.0,
                            top_k=None)
    assert got[0] == jeng.completions()[0]


def test_watchdog_breaks_hung_step_and_retry_is_bitwise(model):
    """A hung launch becomes WatchdogTimeout (deadline 0.5 s) and retries
    like any transient: the re-run tick is bitwise the original."""
    eng = _engine(model, temperature=0.0, top_k=None, step_deadline_s=0.5,
                  retry_base_delay_s=0.01)
    real = eng.fns.decode
    state = {"hung": False}

    def hang_once(*a, **kw):
        if not state["hung"]:
            state["hung"] = True
            end = time.monotonic() + 30.0
            while time.monotonic() < end:  # interruptible: small slices
                time.sleep(0.02)
        return real(*a, **kw)

    eng.fns.decode = hang_once
    _submit_all(eng, PROMPTS[:2], MAX_NEW[:2])
    t0 = time.perf_counter()
    eng.run()
    assert time.perf_counter() - t0 < 15.0 and state["hung"]
    assert eng.launch_failures == 1
    assert eng.completions() == _oracle(model, prompts=PROMPTS[:2],
                                        max_new=MAX_NEW[:2],
                                        temperature=0.0, top_k=None)
    eng.sched.pool.check_leaks()
    eng.close()


def test_step_exception_and_pool_pressure_storm_is_invisible(model):
    sched = FaultSchedule([Fault("serve_step_exception", 2),
                           Fault("pool_pressure", 4, 4.0)])
    eng = _engine(model, chaos=sched, retry_base_delay_s=0.001, **SAMPLED)
    _submit_all(eng)
    eng.run()
    assert eng.completions() == _oracle(model, **SAMPLED)
    assert sched.serve_events() == [] and len(sched.fired) == 2
    assert eng.launch_failures == 1
    eng.sched.pool.check_leaks()
    assert eng.live_blocks() == 0


def test_arrival_burst_and_client_abandon(model):
    """A burst-injected request streams to completion bitwise like any
    other; an abandon cancels the lowest live rid, whose delivered tokens
    stay a prefix."""
    def burst(n, now):
        assert n == 1
        return [Request(rid=1000, prompt=PROMPTS[0], max_new_tokens=4,
                        rng=np.array([0, 42], np.uint32), arrival=now)]

    sched = FaultSchedule([Fault("arrival_burst", 3, 1.0),
                           Fault("client_abandon", 6, 0.0)])
    eng = _engine(model, chaos=sched, burst_factory=burst, **SAMPLED)
    _submit_all(eng)
    eng.run()
    assert sched.serve_events() == [] and len(sched.fired) == 2
    solo = _engine(model, **SAMPLED)
    solo.submit(Request(rid=1000, prompt=PROMPTS[0], max_new_tokens=4,
                        rng=np.array([0, 42], np.uint32)))
    solo.run()
    assert eng.completions()[1000] == solo.completions()[1000]
    assert [r for r, st in eng.sched.finished.items()
            if st == "cancelled"] == [0]
    want = _oracle(model, **SAMPLED)
    assert eng.completions()[0] == want[0][:len(eng.completions()[0])]
    for i in (1, 2):
        assert eng.completions()[i] == want[i]
    eng.sched.pool.check_leaks()


def test_seeded_serve_storm_with_snapshots_restores_bitwise(model,
                                                            tmp_path):
    """A seeded storm over every serve kind but the abandons and bursts
    (which change what is served), snapshots every 5 ticks, then a kill
    and a restore: the streams are the uninterrupted engine's."""
    kinds = tuple(k for k in SERVE_KINDS
                  if k not in ("client_abandon", "arrival_burst"))
    sched = FaultSchedule.random_serve(4, max_position=20, kinds=kinds,
                                       n_faults=4)
    kw = dict(SAMPLED, snapshot_dir=str(tmp_path / "s"))
    eng = _engine(model, chaos=sched, retry_base_delay_s=0.001, **kw)
    _submit_all(eng)
    for t in range(22):
        eng.step()
        if (t + 1) % 5 == 0:
            eng.save_snapshot(async_=t % 2 == 0)
    assert sched.serve_events() == []
    eng.close()
    eng2 = _engine(model, **kw)
    assert eng2.restore_latest_snapshot() is not None
    eng2.run()
    assert eng2.completions() == _oracle(model, **SAMPLED)
    eng2.sched.pool.check_leaks()
    eng2.close()


def test_replay_continuations_rebuild_the_cache_by_decode_steps(model,
                                                                tmp_path):
    """The card's continuations (``"replay"``; the engine picks it on a
    CUDA device), set on CPU engines here: a preempted stream (tight pool)
    and a restored one re-prefill only their prompt and feed their emitted
    tokens back through decode steps; every stream is the uninterrupted
    engine's bitwise, at more decode steps than the re-prefilling
    schedule takes."""
    want = _oracle(model, geo=TIGHT, prompts=TIGHT_PROMPTS,
                   max_new=TIGHT_MAX_NEW, **SAMPLED)
    steps = {}
    for mode in ("prefill", "replay"):
        eng = _engine(model, geo=TIGHT, **SAMPLED)
        eng.sched.continuations = mode
        _submit_all(eng, TIGHT_PROMPTS, TIGHT_MAX_NEW)
        eng.run()
        assert eng.sched.preemptions >= 1
        assert eng.completions() == want, mode
        steps[mode] = dict(eng.steps)
        eng.sched.pool.check_leaks()
    assert steps["replay"]["decode"] > steps["prefill"]["decode"]
    got = _kill_and_restore(model, tmp_path, continuations="replay")
    assert got == _oracle(model, **SAMPLED)
    # the engine picks the form from its device: "prefill" on the CPU
    assert Scheduler(slots=2, num_blocks=9, block_size=8, prefill_chunk=8,
                     max_len=64).continuations == "prefill"
    eng = _engine(model, **SAMPLED)
    assert eng.sched.continuations == "prefill"
    eng.close()
