"""The PyTorch port's serving engine held to the JAX package's engine and to
its own one-shot generator.

Geometry is the serve CLI's (vocab 256, 2 layers, 2 heads, d_model 32,
d_ff 64, max_len 64, float32), with the JAX weights bridged into the port.
On the CPU the port's K6 wrapper runs its plain version; the JAX engine
runs with ``decode_impl="auto"``, which resolves to its dense path here.

* Greedy and sampled streams: port engine == JAX engine, token for
  token (float32 logits agree to ~1e-5, far inside the argmax margins of
  these seeds; sampling draws JAX's threefry ``fold_in(rng, p)`` keys and
  Gumbel noise, the latter within an ulp of each log).
* Port engine == port one-shot, bitwise, greedy and sampled: both sample
  position p of a request with the key of (request key, p), and the
  scheduler's interleaving, chunking and preemption never change p.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.serve import Request as JRequest
from distributed_tensorflow_guide_tpu.serve import ServeEngine as JServeEngine
from distributed_tensorflow_guide_tpu.serve import paged_cache as jpc
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.obs import events as obs_events
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.serve import cli
from distributed_tensorflow_guide_tpu_torch.serve import paged_cache as tpc
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
)

JCFG = jtf.TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                             d_model=32, d_ff=64, max_len=64, causal=True,
                             dtype=jnp.float32)
TCFG = ttf.TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                             d_model=32, d_ff=64, max_len=64, causal=True,
                             dtype=torch.float32)

PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32),
           np.array([1] * 17, np.int32)]
MAX_NEW = [8, 6, 10]
# two residents that need ~92 positions between them in a pool of 8
# blocks x 8 = 64: one is preempted mid-decode and re-prefilled
TIGHT_PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
                 np.array([2, 4, 6, 8, 10, 12, 14], np.int32)]
TIGHT_MAX_NEW = [40, 40]
ROOMY = dict(slots=2, num_blocks=33, block_size=8, prefill_chunk=8)
TIGHT = dict(slots=2, num_blocks=9, block_size=8, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _isolated_table(isolated_autotune_table):
    yield


@pytest.fixture(scope="module")
def jparams():
    return jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def model(jparams):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    m = ttf.Transformer(TCFG)
    m.load_state_dict(bridge.params_from_flax(tree, TCFG))
    return m.eval()


def _key(i):
    return np.array([0, 100 + i], np.uint32)  # == jax.random.PRNGKey(100+i)


def _serve(model, *, temp=0.0, top_k=None, prompts=PROMPTS,
           max_new=MAX_NEW, cfg=TCFG, **kw):
    kw = {**ROOMY, **kw}
    eng = ServeEngine(cfg, model, temperature=temp, top_k=top_k,
                      device="cpu", **kw)
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i)))
    events = eng.run()
    return eng, events


def _one_shot(model, i, *, temp=0.0, top_k=None, prompts=PROMPTS,
              max_new=MAX_NEW, cfg=TCFG):
    gen = tgen.make_generate_fn(cfg, max_new_tokens=max_new[i],
                                temperature=temp, top_k=top_k, device="cpu")
    out = gen(model, prompts[i][None], _key(i))
    return out[0, len(prompts[i]):].tolist()


# ---- port engine == JAX engine (greedy) -------------------------------------


@pytest.mark.parametrize("pool", ["roomy", "preempting"])
def test_engine_greedy_streams_equal_jax_engine(jparams, model, pool):
    """The same requests through both engines: identical streams, and the
    same scheduling (step counts, preemptions) — the host side is the
    JAX package's scheduler, copied."""
    prompts, max_new, geo = ((PROMPTS, MAX_NEW, ROOMY) if pool == "roomy"
                             else (TIGHT_PROMPTS, TIGHT_MAX_NEW, TIGHT))
    jeng = JServeEngine(JCFG, jparams, temperature=0.0, top_k=None, **geo)
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn,
                             rng=jax.random.PRNGKey(100 + i)))
    jevents = jeng.run()
    DA.reset_launch_counts()
    eng, events = _serve(model, prompts=prompts, max_new=max_new, **geo)
    assert eng.completions() == jeng.completions()
    assert ([(e.rid, e.token, e.first, e.done) for e in events]
            == [(e.rid, e.token, e.first, e.done) for e in jevents])
    assert eng.steps == jeng.steps
    assert eng.sched.preemptions == jeng.sched.preemptions
    if pool == "preempting":
        assert eng.sched.preemptions >= 1
    # CPU tensors take the plain version: no kernel launch is counted
    assert DA.LAUNCHES["paged_decode_attention"] == 0
    eng.sched.pool.check_leaks()
    assert eng.live_blocks() == 0


@pytest.mark.parametrize("top_k", [10, None], ids=["top10", "full"])
@pytest.mark.parametrize("pool", ["roomy", "preempting"])
def test_engine_sampled_streams_equal_jax_engine(jparams, model, pool,
                                                 top_k):
    """Temperature 0.8 through both engines, the same requests and keys:
    identical streams and scheduling, through preemption too."""
    prompts, max_new, geo = ((PROMPTS, MAX_NEW, ROOMY) if pool == "roomy"
                             else (TIGHT_PROMPTS, TIGHT_MAX_NEW, TIGHT))
    jeng = JServeEngine(JCFG, jparams, temperature=0.8, top_k=top_k, **geo)
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn,
                             rng=jax.random.PRNGKey(100 + i)))
    jeng.run()
    eng, _ = _serve(model, temp=0.8, top_k=top_k, prompts=prompts,
                    max_new=max_new, **geo)
    assert eng.completions() == jeng.completions()
    assert eng.steps == jeng.steps
    assert eng.sched.preemptions == jeng.sched.preemptions


# ---- port engine == port one-shot, bitwise ----------------------------------


@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_engine_equals_one_shot_bitwise(model, temp, top_k):
    eng, events = _serve(model, temp=temp, top_k=top_k)
    got = eng.completions()
    for i in range(len(PROMPTS)):
        assert got[i] == _one_shot(model, i, temp=temp, top_k=top_k), i
    assert sorted(e.rid for e in events if e.first) == [0, 1, 2]
    assert sorted(e.rid for e in events if e.done) == [0, 1, 2]
    eng.sched.pool.check_leaks()


@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_tensor_prompts_and_rngs_give_the_numpy_bits(model, temp, top_k):
    """The generator and the engine take the prompt and the rng as torch
    tensors too (int64, here on the CPU; the card's test gives CUDA
    ones): the same bits as their numpy-fed runs."""
    as_t = [torch.as_tensor(p, dtype=torch.int64) for p in PROMPTS]
    eng, _ = _serve(model, temp=temp, top_k=top_k)
    teng = ServeEngine(TCFG, model, temperature=temp, top_k=top_k,
                       device="cpu", **ROOMY)
    for i, (p, mn) in enumerate(zip(as_t, MAX_NEW)):
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=mn,
                            rng=torch.as_tensor(_key(i).astype(np.int64))))
    teng.run()
    assert teng.completions() == eng.completions()
    gen = tgen.make_generate_fn(TCFG, max_new_tokens=6, temperature=temp,
                                top_k=top_k, device="cpu")
    for i, p in enumerate(PROMPTS):
        want = gen(model, p[None], _key(i))
        got = gen(model, as_t[i][None],
                  torch.as_tensor(_key(i).astype(np.int64)))
        assert got.dtype == want.dtype and torch.equal(got, want), i


def test_engine_equals_one_shot_through_preemption_sampled(model):
    eng, _ = _serve(model, temp=0.7, top_k=12, prompts=TIGHT_PROMPTS,
                    max_new=TIGHT_MAX_NEW, **TIGHT)
    assert eng.sched.preemptions >= 1
    got = eng.completions()
    for i in range(2):
        assert got[i] == _one_shot(model, i, temp=0.7, top_k=12,
                                   prompts=TIGHT_PROMPTS,
                                   max_new=TIGHT_MAX_NEW), i
    eng.sched.pool.check_leaks()


def test_int8_pool_engine_equals_int8_one_shot(model):
    """The int8 KV lever: the pool and the contiguous cache quantise the
    same rows the same way, so the streams stay bitwise equal."""
    cfg = dataclasses.replace(TCFG, kv_dtype="int8")
    eng, _ = _serve(model.with_config(cfg), temp=0.8, top_k=10, cfg=cfg)
    got = eng.completions()
    for i in range(len(PROMPTS)):
        assert got[i] == _one_shot(model, i, temp=0.8, top_k=10, cfg=cfg), i


def test_chunked_prefill_equals_whole_prompt(model):
    chunked, _ = _serve(model, temp=0.8, top_k=10, prefill_chunk=8)
    whole, _ = _serve(model, temp=0.8, top_k=10, prefill_chunk=32)
    assert chunked.completions() == whole.completions()
    assert chunked.steps["prefill"] > len(PROMPTS)
    assert whole.steps["prefill"] == len(PROMPTS)


def test_prefix_cache_saves_prefill_and_keeps_streams(model):
    """Requests sharing a 16-token system prompt: the radix index hands
    the second and third their prefix blocks, and every stream is the one
    served without the cache."""
    sys_prompt = np.arange(40, 56, dtype=np.int32)
    prompts = [np.concatenate([sys_prompt, p[:4]]) for p in PROMPTS]
    max_new = [6, 6, 6]
    plain, _ = _serve(model, prompts=prompts, max_new=max_new, slots=1)
    cached, _ = _serve(model, prompts=prompts, max_new=max_new, slots=1,
                       prefix_cache=True)
    assert cached.completions() == plain.completions()
    assert cached.health()["prefill_tokens_saved"] >= 16
    cached.close()
    cached.sched.check_leaks()
    cached.sched.pool.check_leaks()


# ---- engine surface ---------------------------------------------------------


def test_launch_failure_is_retried_bitwise(model):
    """A step launch that raises once is retried from host state: the
    streams are those of a clean run and the failure is counted."""
    clean, _ = _serve(model, temp=0.8, top_k=10)
    eng = ServeEngine(TCFG, model, temperature=0.8, top_k=10, device="cpu",
                      retry_base_delay_s=0.0, **ROOMY)
    decode, calls = eng.fns.decode, []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected launch failure")
        return decode(*args)

    eng.fns.decode = flaky
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i)))
    eng.run()
    assert eng.completions() == clean.completions()
    assert eng.health()["launch_failures"] == 1


def test_recorder_sees_the_request_lifecycle(model):
    rec = obs_events.FlightRecorder(capacity=4096)
    eng = ServeEngine(TCFG, model, device="cpu", recorder=rec, **ROOMY)
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i)))
    eng.run()
    kinds = [e.kind for e in rec.events()]
    for kind in ("req.submit", "prefill.launch", "decode.launch",
                 "req.first_token", "req.done"):
        assert kind in kinds, kind
    assert kinds.count("req.done") == len(PROMPTS)


def test_submit_validation_and_deferred_knobs(model, tmp_path):
    eng = ServeEngine(TCFG, model, device="cpu", slots=2, num_blocks=5,
                      block_size=8, prefill_chunk=8)
    with pytest.raises(ValueError, match="out of vocabulary"):
        eng.submit(Request(rid=0, prompt=np.array([999], np.int32),
                           max_new_tokens=4, rng=_key(0)))
    with pytest.raises(ValueError, match="never fit"):
        eng.submit(Request(rid=1, prompt=np.array([1] * 30, np.int32),
                           max_new_tokens=8, rng=_key(1)))
    with pytest.raises(ValueError, match="adapter"):
        eng.submit(Request(rid=2, prompt=np.array([1, 2], np.int32),
                           max_new_tokens=2, rng=_key(2), adapter=1))
    # online tuning is served now: the knob sets the process override,
    # and on the CPU the engine keeps the default decode split
    from distributed_tensorflow_guide_tpu_torch.ops import autotune
    from distributed_tensorflow_guide_tpu_torch.ops import (
        decode_attention as DA,
    )
    try:
        tuned = ServeEngine(TCFG, model, device="cpu", **ROOMY,
                            online_tune=1)
        assert autotune.online_tune_enabled()
        assert tuned.fns.cfg.decode_split_keys == DA.split_keys(
            TCFG.cache_dtype, TCFG.head_dim)
        tuned.close()
    finally:
        autotune.set_online_tune(None)
    with pytest.raises(TypeError, match="unexpected keyword"):
        ServeEngine(TCFG, model, device="cpu", **ROOMY, no_such_knob=1)
    # the host spill tier and warm cache persistence are served now:
    # each builds an engine, persist_cache with the snapshot directory and
    # prefix cache it needs, and without them it is refused as the JAX
    # engine refuses it
    ServeEngine(TCFG, model, device="cpu", **ROOMY, host_blocks=1).close()
    ServeEngine(TCFG, model, device="cpu", **ROOMY, host_blocks=4,
                persist_cache=True, prefix_cache=True,
                snapshot_dir=str(tmp_path / "warm")).close()
    for kw, why in ((dict(host_blocks=4, prefix_cache=True),
                     "snapshot_dir"),
                    (dict(host_blocks=4, snapshot_dir=str(tmp_path / "w")),
                     "prefix_cache"),
                    (dict(prefix_cache=True,
                          snapshot_dir=str(tmp_path / "w")),
                     "host_blocks")):
        with pytest.raises(ValueError, match=why):
            ServeEngine(TCFG, model, device="cpu", **ROOMY,
                        persist_cache=True, **kw)
    # the resilience knobs are served now: each builds an engine
    from distributed_tensorflow_guide_tpu_torch.testing.chaos import (
        FaultSchedule,
    )
    for knob, value in (("chaos", FaultSchedule()),
                        ("snapshot_dir", str(tmp_path / "snap")),
                        ("step_deadline_s", 5.0)):
        eng = ServeEngine(TCFG, model, device="cpu", **ROOMY,
                          **{knob: value})
        eng.close()
    # adapters are served now: a bank without lora_rank is refused, as
    # the JAX engine refuses it
    with pytest.raises(ValueError, match="adapters"):
        ServeEngine(TCFG, model, device="cpu", **ROOMY,
                    adapters={"x": torch.zeros((1,))})
    with pytest.raises(TypeError):
        ServeEngine(TCFG, model, device="cpu", **ROOMY, fleet=2)


def test_cli_serves_on_the_cpu_when_asked(capsys):
    cli.main(["--device", "cpu", "--requests", "3", "--max-new", "4",
              "--prefix-cache"])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert out.rstrip().endswith("pool.check_leaks(): clean")
    assert out.count(" $ token ") == 3  # one completion per request


# ---- paged cache: gather / scatter against the JAX helpers ------------------


@pytest.mark.parametrize("seq_axis", [2, 3], ids=["kv", "scales"])
def test_scatter_and_gather_match_jax(seq_axis):
    """Chunks written through shuffled tables land where the JAX scatter
    puts them (the trash block aside: idle writers collide there and
    which duplicate wins is unspecified), and the gathered views agree."""
    rng = np.random.RandomState(seq_axis)
    nb, h, bs, hd, n_blk, C = 9, 2, 4, 3, 4, 3
    shape = (nb, h, bs, hd) if seq_axis == 2 else (nb, h, 1, bs)
    pool = rng.randn(*shape).astype(np.float32)
    tables = np.stack([rng.permutation(nb - 1)[:n_blk],
                       np.full(n_blk, nb - 1)]).astype(np.int32)  # idle
    index = np.array([5, 2], np.int32)
    chunk_shape = list(shape)
    chunk_shape[0], chunk_shape[seq_axis] = 2, C
    chunk = rng.randn(*chunk_shape).astype(np.float32)
    want = np.asarray(jpc.scatter_chunk(
        jnp.asarray(pool), jnp.asarray(chunk), jnp.asarray(tables),
        jnp.asarray(index), block_size=bs, seq_axis=seq_axis))
    got = torch.from_numpy(pool.copy())
    out = tpc.scatter_chunk(got, torch.from_numpy(chunk),
                            torch.from_numpy(tables), torch.from_numpy(index),
                            block_size=bs, seq_axis=seq_axis)
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy()[:-1], want[:-1])
    view = tpc.gather_view(got, torch.from_numpy(tables[:1]),
                           seq_axis=seq_axis)
    jview = jpc.gather_view(jnp.asarray(want), jnp.asarray(tables[:1]),
                            seq_axis=seq_axis)
    np.testing.assert_array_equal(view.numpy(), np.asarray(jview))
