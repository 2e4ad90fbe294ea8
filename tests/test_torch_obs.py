"""The port's metrics plane (``obs/metrics.py``, ``obs/tracing.py``,
``obs/recon.py``, ``obs/cli.py``, ``utils/tb_writer.py``, and the
``MetricsHook`` / ``TensorBoardHook`` of ``train/hooks.py``) held to the
JAX package's ``tests/test_obs.py`` pins (its tests at lines 156, 181,
196, 228, 283, 310, 325, 351, 426, 449, 600, 623 and 637) on the CPU,
and to the JAX package's own modules: the same health dicts absorbed by
both give the same metric names, labels and values, and the same event
list gives the same Chrome trace.

The roofline defaults are the port's (the H100 SXM data sheet), not the
JAX package's. Geometry: the JAX tests' engine (vocab 64, 2 layers,
d_model 16, float32).
"""

import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.obs import events as jevents
from distributed_tensorflow_guide_tpu.obs import metrics as jmetrics
from distributed_tensorflow_guide_tpu.obs import tracing as jtracing
from distributed_tensorflow_guide_tpu.utils import tb_writer as jtb
from distributed_tensorflow_guide_tpu_torch.data.prefetch import (
    PrefetchStats,
)
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.obs import cli as obs_cli
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_guide_tpu_torch.obs import recon as obs_recon
from distributed_tensorflow_guide_tpu_torch.obs import tracing as obs_trace
from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
    DataParallel,
)
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
)
from distributed_tensorflow_guide_tpu_torch.serve.fleet import FleetScheduler
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    BlockPool,
)
from distributed_tensorflow_guide_tpu_torch.serve.prefix_index import (
    PrefixIndex,
)
from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
    Fault,
    FaultSchedule,
)
from distributed_tensorflow_guide_tpu_torch.train.hooks import (
    MetricsHook,
    StopAtStepHook,
    TensorBoardHook,
)
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState
from distributed_tensorflow_guide_tpu_torch.utils.profiling import (
    DispatchStats,
)
from distributed_tensorflow_guide_tpu_torch.utils.tb_writer import (
    SummaryWriter,
    read_scalars,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny ops: one intra-op thread a worker keeps them from spinning
    against the other test workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = ttf.TransformerConfig(vocab_size=64, num_layers=2, num_heads=2,
                            d_model=16, d_ff=32, max_len=64, causal=True,
                            dtype=torch.float32)
MOE_CFG = dataclasses.replace(CFG, moe_experts=4, moe_capacity=2)
PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32),
           np.array([1] * 17, np.int32)]
MAX_NEW = [8, 6, 10]
GEO = dict(slots=2, num_blocks=33, block_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def model():
    return ttf.Transformer(CFG).init_weights(0).eval()


def _engine(model, *, cfg=CFG, recorder=None, prompts=PROMPTS,
            max_new=MAX_NEW, **kw):
    kw = {**GEO, **kw}
    eng = ServeEngine(cfg, model, temperature=0.8, top_k=10,
                      recorder=recorder, device="cpu", **kw)
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn,
                           rng=np.array([0, 100 + i], np.uint32)))
    return eng


def _drive(eng):
    """Step on a finite virtual clock, so every event carries a real
    semantic timestamp."""
    now = 0.0
    while (eng.sched.has_queued or eng.sched.has_resident
           or eng._pressure_holds):
        eng.step(now)
        now += 0.01


def _both(absorb, *args):
    """The same stats absorbed by the port's and the JAX package's
    absorber: (port snapshot, JAX snapshot, port text, JAX text)."""
    t, j = obs_metrics.Registry(), jmetrics.Registry()
    getattr(obs_metrics, absorb)(t, *args)
    getattr(jmetrics, absorb)(j, *args)
    return t.snapshot(), j.snapshot(), t.to_prometheus(), j.to_prometheus()


# ---- the registry -----------------------------------------------------------


def test_registry_counters_gauges_histograms():
    reg = obs_metrics.Registry()
    reg.counter("dtg_c", "help").inc(3)
    reg.counter("dtg_c").inc()
    with pytest.raises(ValueError, match="decrease"):
        reg.counter("dtg_c").inc(-1)
    reg.gauge("dtg_g", labels={"tenant": "0"}).set(2.5)
    h = reg.histogram("dtg_h", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    snap = reg.snapshot()
    assert snap["dtg_c"] == 4.0
    assert snap['dtg_g{tenant="0"}'] == 2.5
    assert snap["dtg_h"]["count"] == 3 and snap["dtg_h"]["sum"] == 5.55
    assert snap["dtg_h"]["buckets"] == {0.1: 1, 1.0: 2}
    with pytest.raises(TypeError, match="registered as counter"):
        reg.gauge("dtg_c")
    text = reg.to_prometheus()
    assert "# TYPE dtg_c counter" in text
    assert 'dtg_g{tenant="0"} 2.5' in text
    assert 'dtg_h_bucket{le="+Inf"} 3' in text
    assert "dtg_h_sum 5.55" in text


def test_absorbers_map_existing_stats():
    """The port's DispatchStats and PrefetchStats through both packages'
    absorbers: the same series."""
    ds = DispatchStats(dispatches=4, steps=2, host_gap_s=0.2,
                       dispatch_s=0.05)
    ps = PrefetchStats(batches=3, host_wait_s=0.1, put_s=0.01,
                       peak_ahead=2, max_host_wait_s=0.08)
    t, j, tt, jt = _both("absorb_dispatch", ds)
    assert t == j and tt == jt
    assert t["dtg_train_dispatches_total"] == 4
    assert t["dtg_train_host_gap_ms_per_dispatch"] == pytest.approx(50.0)
    t, j, tt, jt = _both("absorb_prefetch", ps)
    assert t == j and tt == jt
    assert t["dtg_data_prefetch_batches_total"] == 3
    assert t["dtg_data_prefetch_peak_ahead"] == 2


def test_pool_and_prefix_stats_shapes():
    pool = BlockPool(num_blocks=5, block_size=8)
    blocks = pool.alloc(1, 1)
    pool.share(2, blocks)
    s = pool.stats()
    assert s == {"capacity": 4, "free": 3, "live": 1, "shared": 1,
                 "holds": 2}
    pool.free(1, blocks)
    pool.free(2, blocks)
    pool.check_leaks()
    idx = PrefixIndex(block_size=4)
    assert idx.stats() == {"nodes": 0, "leaves": 0, "max_depth": 0,
                           "adapters": 0, "spilled": 0}
    for absorb, stats in (("absorb_pool", s),
                          ("absorb_prefix", idx.stats())):
        t, j, tt, jt = _both(absorb, stats)
        assert t == j and tt == jt
    reg = obs_metrics.Registry()
    obs_metrics.absorb_pool(reg, s)
    obs_metrics.absorb_prefix(reg, idx.stats())
    snap = reg.snapshot()
    assert snap["dtg_serve_pool_live"] == 1
    assert snap["dtg_serve_prefix_nodes"] == 0
    assert snap["dtg_serve_prefix_spilled"] == 0


# ---- the chrome trace exporter ----------------------------------------------


def test_chrome_exporter_schema():
    rec = obs_events.FlightRecorder()
    rec.emit("span.begin", cat="train",
             payload={"name": "s", "track": "loop", "step": 0}, t=1.0)
    rec.emit("span.end", cat="train",
             payload={"name": "s", "track": "loop"}, t=2.0)
    rec.emit("prefill.launch", cat="serve",
             payload={"slot": 0, "rid": 1, "chunk": 8, "dur_s": 0.5},
             t=3.0)
    rec.emit("decode.launch", cat="serve",
             payload={"slots": [0, 1], "rids": [1, 2], "tick": 1,
                      "dur_s": 0.25}, t=4.0)
    rec.emit("req.admit", cat="serve",
             payload={"rid": 3, "slot": 1, "queue_wait_s": 0.5}, t=5.0)
    rec.emit("req.done", cat="serve", payload={"rid": 1, "tick": 2},
             t=6.0)
    rec.emit("req.admit", cat="serve", payload={"rid": 9},
             t=float("inf"))
    trace = obs_trace.to_chrome_trace(rec.events())
    json.dumps(trace)
    evs = trace["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    real = [e for e in evs if e["ph"] != "M"]
    assert not any(e.get("args", {}).get("rid") == 9 for e in real)
    b = [(e["pid"], e["tid"], e["name"]) for e in real if e["ph"] == "B"]
    e_ = [(e["pid"], e["tid"], e["name"]) for e in real if e["ph"] == "E"]
    assert b and sorted(b) == sorted(e_)
    xs = [e for e in real if e["ph"] == "X"]
    assert {e["name"] for e in xs} >= {"decode rid1", "decode rid2",
                                       "prefill rid1"}
    bar = next(e for e in xs if e["name"] == "rid3 queued")
    assert bar["ts"] == pytest.approx(5.0e6 - 0.5e6)
    assert bar["dur"] == pytest.approx(0.5e6)
    used = {(e["pid"], e["tid"]) for e in real}
    named = [(e["pid"], e["tid"]) for e in meta
             if e["name"] == "thread_name"]
    assert len(named) == len(set(named)) and used <= set(named)
    assert {e["pid"] for e in real} == \
        {e["pid"] for e in meta if e["name"] == "process_name"}
    inst = [e for e in real if e["ph"] == "i"]
    assert inst and all(e["s"] == "t" and math.isfinite(e["ts"])
                        for e in inst)


def _as_jax_events(events):
    """The port's events as the JAX package's, which have no ``wall_ns``."""
    return [jevents.ObsEvent(**{k: v for k, v in dataclasses.asdict(e).items()
                                if k != "wall_ns"}) for e in events]


# ---- inertness: the recorder on or off is invisible ------------------------


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_engine_bitwise_parity_recorder_on_off(model, kv):
    cfg = dataclasses.replace(CFG, kv_dtype=kv)
    off = _engine(model, cfg=cfg)
    off.run()
    rec = obs_events.FlightRecorder()
    on = _engine(model, cfg=cfg, recorder=rec)
    on.run()
    assert on.completions() == off.completions()
    kinds = {e.kind for e in rec.events()}
    assert {"req.submit", "req.admit", "prefill.launch", "decode.launch",
            "req.first_token", "req.done"} <= kinds
    assert sorted(e.payload["rid"] for e in rec.events()
                  if e.kind == "req.done") == [0, 1, 2]
    rec2 = obs_events.FlightRecorder()
    _engine(model, cfg=cfg, recorder=rec2).run()
    assert obs_events.signature(rec2.events()) == \
        obs_events.signature(rec.events())
    # the profiler on too: its ranges change nothing the engine computes
    rec3 = obs_events.FlightRecorder()
    with _cpu_profile():
        profiled = _engine(model, cfg=cfg, recorder=rec3)
        profiled.run()
    assert profiled.completions() == off.completions()
    assert obs_events.signature(rec3.events()) == \
        obs_events.signature(rec.events())


def test_train_loop_bitwise_parity_and_spans():
    def step(state, batch):
        new = state - 0.01 * (2 * state + batch["x"])
        return new, {"loss": (state ** 2).sum()}

    def data():
        return ({"x": torch.full((4,), float(s))} for s in range(10_000))

    off = TrainLoop(step, torch.ones(4), data(), hooks=[StopAtStepHook(50)],
                    device="cpu").run()
    rec = obs_events.FlightRecorder(capacity=1 << 12)
    on = TrainLoop(step, torch.ones(4), data(), hooks=[StopAtStepHook(50)],
                   recorder=rec, device="cpu").run()
    assert torch.equal(off, on)
    kinds = [e.kind for e in rec.events()]
    assert kinds.count("span.begin") == kinds.count("span.end") == 100
    rec2 = obs_events.FlightRecorder(capacity=1 << 12)
    with _cpu_profile() as prof:
        profiled = TrainLoop(step, torch.ones(4), data(),
                             hooks=[StopAtStepHook(50)], recorder=rec2,
                             device="cpu").run()
    assert torch.equal(off, profiled)
    assert obs_events.signature(rec2.events()) == \
        obs_events.signature(rec.events())
    ranges = _ranges(prof, ("data_wait", "dispatch"))
    assert len(ranges["data_wait"]) == len(ranges["dispatch"]) == 50


# ---- phase spans: the tick's stats, profiler ranges, the wall clock ---------

TICK_PHASES = ("serve.pack", "serve.launch", "serve.readback", "serve.apply")
SERVE_RANGES = ("serve.tick", "serve.schedule") + TICK_PHASES
STEP_RANGES = ("forward", "backward", "grad_sync", "optimizer")
LOOP_RANGES = ("data_wait", "dispatch")


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof, names) -> dict:
    """{name: [(start_ns, end_ns)]} of the profile's host ranges."""
    out = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out:
            out[e.name()].append((e.start_ns(),
                                  e.start_ns() + e.duration_ns()))
    return out


def _within(inner, outer) -> bool:
    """Every range of ``inner`` lies inside one range of ``outer``."""
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def _lm_loop(model_seed: int = 0, steps: int = 2):
    """A tiny LM trained eagerly: ``DataParallel.make_train_step`` in a
    ``TrainLoop`` over ``steps`` batches."""
    m = ttf.Transformer(CFG).init_weights(model_seed)
    state = TrainState(m, torch.optim.SGD(m.parameters(), lr=0.1))
    step = DataParallel(device="cpu").make_train_step(
        ttf.make_lm_loss_fn(m))
    gen = torch.Generator().manual_seed(model_seed)
    data = [{"tokens": torch.randint(0, CFG.vocab_size, (2, 16),
                                     generator=gen)} for _ in range(steps)]
    return TrainLoop(step, state, data, device="cpu")


def test_tick_phases_count_ticks_and_sum_to_last_tick(model):
    eng = _engine(model)
    ticks, launched_s, now = 0, 0.0, 0.0
    while eng.sched.has_queued or eng.sched.has_resident:
        _, kind = eng.step(now)
        now += 0.01
        ticks += 1
        if kind != "idle":
            launched_s += eng.last_tick_s
    ph = eng.tick_phases.snapshot()
    launches = eng.steps["decode"] + eng.steps["prefill"]
    assert eng.steps["decode"] and eng.steps["prefill"]
    assert ph["counts"]["serve.tick"] == ph["counts"]["serve.schedule"] \
        == ticks
    assert all(ph["counts"][k] == launches for k in TICK_PHASES)
    inner = sum(ph["seconds"][k] for k in TICK_PHASES)
    assert inner <= launched_s
    assert inner == pytest.approx(launched_s, rel=0.05)
    assert ph["seconds"]["serve.tick"] >= (ph["seconds"]["serve.schedule"]
                                           + launched_s)


def test_profiler_ranges_exist_and_nest(model):
    with _cpu_profile() as prof:
        _drive(_engine(model))
        _lm_loop().run()
    r = _ranges(prof, SERVE_RANGES + STEP_RANGES + LOOP_RANGES)
    assert all(r[n] for n in r), {n: len(v) for n, v in r.items()}
    for n in ("serve.schedule",) + TICK_PHASES:
        assert _within(r[n], r["serve.tick"]), n
    for n in STEP_RANGES:
        assert _within(r[n], r["dispatch"]), n
    assert len(r["dispatch"]) == 2 and len(r["data_wait"]) == 3
    assert not any(a < e and s < b for s, e in r["data_wait"]
                   for a, b in r["dispatch"])
    # the phases of one tick follow one another
    for a, b in zip(TICK_PHASES, TICK_PHASES[1:]):
        assert all(ea <= sb for (_, ea), (sb, _) in zip(r[a], r[b])), (a, b)


def test_no_record_function_with_the_profiler_off(model, monkeypatch):
    ours = set(SERVE_RANGES + STEP_RANGES + LOOP_RANGES)
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    _drive(_engine(model))
    _lm_loop().run()
    assert not ours & set(entered)
    with _cpu_profile():
        _drive(_engine(model))
        _lm_loop().run()
    assert ours <= set(entered)


def test_recorder_span_wall_clock_brackets_the_profiler_range():
    rec = obs_events.FlightRecorder()
    stats = obs_trace.PhaseStats()
    with _cpu_profile() as prof:
        with obs_trace.span(rec, "bracketed", track="t", stats=stats,
                            args={"step": 3}):
            time.sleep(0.002)
    ((start, end),) = _ranges(prof, ("bracketed",))["bracketed"]
    begin, finish = rec.events()
    assert begin.wall_ns <= start < end <= finish.wall_ns
    assert begin.payload == {"name": "bracketed", "track": "t", "step": 3}
    assert finish.payload == {"name": "bracketed", "track": "t"}
    assert stats.counts == {"bracketed": 1}
    assert stats.seconds["bracketed"] >= 0.002


def test_chrome_trace_on_the_wall_clock(tmp_path):
    rec = obs_events.FlightRecorder()
    with obs_trace.span(rec, "s", track="loop"):
        pass
    rec.emit("decode.launch", cat="serve",
             payload={"slots": [0], "rids": [7], "tick": 0, "dur_s": 0.002},
             t=float("inf"))
    evs = rec.events()
    trace = obs_trace.to_chrome_trace(evs, clock="wall")
    real = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    b, e_, x = real
    assert (b["ph"], e_["ph"], x["ph"]) == ("B", "E", "X")
    assert b["ts"] == evs[0].wall_ns / 1e3
    assert e_["ts"] == evs[1].wall_ns / 1e3
    # a launch event is emitted as its launch ends: its bar starts dur_s
    # earlier; the semantic clock skips it (t is not finite)
    assert x["ts"] == pytest.approx(evs[2].wall_ns / 1e3 - 2000.0)
    assert x["dur"] == pytest.approx(2000.0)
    assert len([e for e in obs_trace.to_chrome_trace(evs)["traceEvents"]
                if e["ph"] != "M"]) == 2
    # a dump keeps wall_ns; an event recorded without it is skipped
    dump = tmp_path / "d.json"
    rec.dump(dump)
    back = obs_trace.events_from_dump(str(dump))
    assert [e.wall_ns for e in back] == [e.wall_ns for e in evs]
    assert obs_trace.to_chrome_trace(back, clock="wall") == trace
    old = [{k: v for k, v in e.to_dict().items() if k != "wall_ns"}
           for e in evs]
    assert not [e for e in obs_trace.to_chrome_trace(
        old, clock="wall")["traceEvents"] if e["ph"] != "M"]
    with pytest.raises(ValueError, match="clock"):
        obs_trace.to_chrome_trace(evs, clock="mono")


# ---- the hooks and the event files ------------------------------------------


def test_metrics_hook_and_tb_roundtrip(tmp_path):
    """MetricsHook mirrors the loop into the registry and, through the
    writer, into an event file that both packages' readers decode to the
    same rows; TensorBoardHook writes the losses ``read_scalars`` gives
    back exactly; the trained state equals a hook-free run's."""
    def step(state, batch):
        return state + batch["x"], {"loss": state.clone()}

    def data():
        return ({"x": torch.tensor(1.0)} for _ in range(10_000))

    plain = TrainLoop(step, torch.tensor(0.0), data(),
                      hooks=[StopAtStepHook(20)], device="cpu").run()
    reg = obs_metrics.Registry()
    with SummaryWriter(tmp_path / "m") as w:
        hook = MetricsHook(reg, every_steps=5, writer=w)
        tb = TensorBoardHook(tmp_path / "tb", every_steps=1)
        hooked = TrainLoop(step, torch.tensor(0.0), data(),
                           hooks=[StopAtStepHook(20), hook, tb],
                           device="cpu").run()
    assert torch.equal(plain, hooked)
    snap = reg.snapshot()
    assert snap["dtg_train_steps_total"] == 20
    assert snap["dtg_train_metric_loss"] == 19.0
    assert snap["dtg_train_dispatches_total"] == 20
    (event_file,) = (tmp_path / "m").glob("events.out.tfevents.*")
    rows = read_scalars(event_file)
    assert rows == jtb.read_scalars(event_file)
    assert rows and rows[-1][1]["dtg_train_steps_total"] == 20.0
    assert [s for s, _ in rows] == [0, 5, 10, 15, 20]  # 20: end()
    (tb_file,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    losses = read_scalars(tb_file)
    assert losses == [(s, {"loss": float(s)}) for s in range(20)]


def test_cli_reads_a_dump_and_writes_a_chrome_trace(model, tmp_path,
                                                    capsys):
    rec = obs_events.FlightRecorder()
    _drive(_engine(model, recorder=rec))
    dump = tmp_path / "dump.json"
    rec.dump(dump)
    assert obs_cli.main([str(dump), "--kind", "req.", "--limit", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("# ") and out.count("req.") == 3
    chrome = tmp_path / "t.json"
    assert obs_cli.main([str(dump), "--chrome", str(chrome)]) == 0
    assert json.loads(chrome.read_text())["traceEvents"]
    assert obs_cli.main([str(tmp_path / "missing.json")]) == 1


# ---- ttft breakdown and the engine / spill / MoE absorbers ------------------


def test_ttft_breakdown_from_driven_engine(model):
    rec = obs_events.FlightRecorder()
    eng = _engine(model, recorder=rec)
    _drive(eng)
    events = rec.events()
    trace = obs_trace.to_chrome_trace(events)
    assert [e for e in trace["traceEvents"] if e["ph"] == "X"]
    # the JAX package's exporter and breakdown over the same events
    jev = _as_jax_events(events)
    assert json.dumps(trace) == json.dumps(jtracing.to_chrome_trace(jev))
    bk = obs_trace.ttft_breakdown(events)
    assert bk == jtracing.ttft_breakdown(jev)
    assert sorted(bk) == [0, 1, 2]
    for parts in bk.values():
        assert set(parts) == {"queue_wait_s", "prefill_s",
                              "first_decode_s"}
        assert parts["prefill_s"] > 0
        assert all(v >= 0 for v in parts.values())
    t, j, tt, jt = _both("absorb_engine", eng.health())
    assert t == j and tt == jt
    assert t["dtg_serve_completed_total"] == 3
    assert t["dtg_serve_ticks_total"] > 0
    assert t["dtg_serve_resident"] == 0


def test_spill_tier_absorbers_from_driven_engine(model):
    eng = _engine(model, host_blocks=8, prefix_cache=True)
    _drive(eng)
    sd = eng.sched
    freed = sd.prefix.demote_many(sd.pool, sd._cache_demote_batch)
    assert freed
    reg = obs_metrics.Registry()
    obs_metrics.absorb_engine(reg, eng.health())
    obs_metrics.absorb_spill_store(reg, eng.store.stats())
    obs_metrics.absorb_prefix(reg, sd.prefix.stats())
    snap = reg.snapshot()
    assert snap["dtg_serve_spill_host_blocks"] == len(freed)
    assert snap["dtg_serve_spill_out_blocks_total"] == len(freed)
    assert snap["dtg_serve_spill_d2h_bytes_total"] > 0
    assert snap["dtg_serve_spill_host_bytes"] == eng.store.bytes_stored()
    assert snap["dtg_serve_spill_store_live"] == len(freed)
    assert snap["dtg_serve_spill_store_holds"] == len(freed)
    assert snap["dtg_serve_prefix_spilled"] == len(freed)
    for absorb, stats in (("absorb_engine", eng.health()),
                          ("absorb_spill_store", eng.store.stats())):
        t, j, tt, jt = _both(absorb, stats)
        assert t == j and tt == jt
    eng.close()
    sd.check_leaks()


def test_moe_census_absorbed_as_the_jax_package_names_it():
    moe = ttf.Transformer(MOE_CFG).init_weights(0).eval()
    eng = _engine(moe, cfg=MOE_CFG)
    eng.run()
    h = eng.health()
    t, j, tt, jt = _both("absorb_engine", h)
    assert t == j and tt == jt
    loads = [t[f'dtg_moe_expert_load_total{{expert="{e}"}}']
             for e in range(4)]
    assert loads == h["moe"]["expert_load"] and sum(loads) > 0
    assert "dtg_moe_stall_ticks_total" in t


# ---- reconciliation ---------------------------------------------------------


def test_reconcile_closed_form():
    roof = obs_recon.Roofline(peak_flops_s=100.0, peak_hbm_bytes_s=50.0,
                              peak_ici_bytes_s=10.0)
    cost = {"flops": 200.0, "hbm_bytes_read": 70.0,
            "hbm_bytes_written": 50.0, "collective_bytes": {"data": 5.0}}
    r = obs_recon.reconcile(cost, 4.0, roof)
    assert r["achieved_gflops_s"] == pytest.approx(200 / 4 / 1e9)
    assert r["achieved_hbm_gb_s"] == pytest.approx(120 / 4 / 1e9)
    assert r["achieved_ici_gb_s"] == pytest.approx(5 / 4 / 1e9)
    assert r["flops_frac"] == pytest.approx(0.5)
    assert r["hbm_frac"] == pytest.approx(0.6)
    assert r["ici_frac"] == pytest.approx(0.125)
    assert r["model_time_s"] == pytest.approx(2.4)
    assert r["efficiency"] == pytest.approx(0.6)
    assert r["bound"] == "memory"
    r2 = obs_recon.reconcile(cost, 4.0, obs_recon.Roofline(100.0, 50.0))
    assert r2["ici_frac"] is None and r2["bound"] == "memory"
    assert "pcie_frac" not in r2
    r3 = obs_recon.reconcile({**cost, "pcie_bytes": 40.0}, 4.0,
                             obs_recon.Roofline(100.0, 50.0,
                                                peak_pcie_bytes_s=5.0))
    assert r3["pcie_frac"] == pytest.approx(2.0) and r3["bound"] == "pcie"
    with pytest.raises(ValueError, match="measured_s"):
        obs_recon.reconcile(cost, 0.0, roof)


def test_roofline_from_env(monkeypatch):
    """The defaults are the H100 SXM data sheet's; the variables
    override each."""
    for k in ("DTG_PEAK_FLOPS", "DTG_PEAK_HBM_BPS", "DTG_PEAK_ICI_BPS",
              "DTG_PEAK_PCIE_BPS"):
        monkeypatch.delenv(k, raising=False)
    roof = obs_recon.Roofline.from_env()
    assert roof.peak_flops_s == 989e12
    assert roof.peak_hbm_bytes_s == 3.35e12
    assert roof.peak_pcie_bytes_s == 64e9
    assert roof.peak_ici_bytes_s is None
    monkeypatch.setenv("DTG_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DTG_PEAK_HBM_BPS", "1e11")
    monkeypatch.setenv("DTG_PEAK_ICI_BPS", "1e10")
    monkeypatch.setenv("DTG_PEAK_PCIE_BPS", "2e10")
    roof = obs_recon.Roofline.from_env()
    assert roof.peak_flops_s == 1e12
    assert roof.peak_hbm_bytes_s == 1e11
    assert roof.peak_ici_bytes_s == 1e10
    assert roof.peak_pcie_bytes_s == 2e10


# ---- the fleet's reliability plane ------------------------------------------


def test_absorb_fleet_shapes_from_real_health(model):
    rec = obs_events.FlightRecorder()
    fc = FaultSchedule([Fault("replica_crash", 3, 0.0),
                        Fault("migration_torn", 3),
                        Fault("replica_stall", 6, 1.0)])
    fl = FleetScheduler(CFG, model, replicas=2, temperature=0.8, top_k=10,
                        fleet_chaos=fc, recorder=rec, device="cpu", **GEO)
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        fl.submit(Request(rid=i, prompt=p, max_new_tokens=mn,
                          rng=np.array([0, 100 + i], np.uint32),
                          tenant=i % 2))
    fl.run()
    h = fl.health()
    kinds = {str(e.kind) for e in rec.events()}
    assert {"fleet.replica_crash", "fleet.replica_stall",
            "fleet.migration_torn", "fleet.migrate_dup",
            "fleet.replica_probe", "fleet.replica_recovered"} <= kinds
    snap, jsnap, text, jtext = _both("absorb_fleet", h)
    assert snap == jsnap and text == jtext
    assert snap["dtg_fleet_replica_crashes_total"] == 1
    assert snap["dtg_fleet_replica_stalls_total"] == 1
    assert snap["dtg_fleet_migration_dups_dropped_total"] == 1
    assert snap["dtg_fleet_breaker_probes_total"] >= 1
    assert snap["dtg_fleet_breaker_recoveries_total"] >= 1
    assert snap["dtg_fleet_completed_total"] == 3
    assert snap["dtg_fleet_stalled_replicas"] == 0
    assert snap["dtg_fleet_draining_replicas"] == 0
    assert snap["dtg_fleet_autoscale_target"] == 2
    assert snap['dtg_fleet_replica_breaker_open'
                '{replica="0",role="colocated"}'] == 0.0
    assert 'dtg_fleet_replica_launch_failures_total' \
        '{replica="0",role="colocated"}' in snap
    assert "dtg_fleet_launch_failures_total" in snap
    assert "dtg_fleet_replica_faults_total" in snap
    fl.check_leaks()
    fl.close()
