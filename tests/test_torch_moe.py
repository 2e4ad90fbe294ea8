"""The port's routed MoE FFN (``models/transformer.MoEMLP``), its quantised
expert banks and its serving engine held to the JAX package on the same
weights, on the CPU.

Geometry is the serving tests' (vocab 256, 2 layers, 2 heads, d_model
32, d_ff 64, max_len 64, float32) with 4 experts, the JAX weights bridged
into the port; inputs come from numpy seeds.

Tolerances:

* ``MoEMLP`` outputs and the MoE ``Transformer``'s logits: f32 atol 1e-5
  (the port's router sums its products in another order); the census
  (load, overflow, overflow_tok), exactly;
* the index dispatch against its one-hot plain version: bitwise (exact
  row copies, one product a token at top-1, two exact bf16 products
  summed once at top-2); f32 top-2 within 1e-6 (the plain einsum may
  fuse a product into the sum);
* ``quantize_params``' bank folding through the bridge: the same bytes;
* serving: the port engine bitwise its solo one-shot generator, greedy
  and sampled, through eviction, with stalls and with int8 banks; greedy
  streams identical to the JAX package's engine and one-shot generator;
  the capacity-1 census balances exactly.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.models import generation as jgen
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.ops import quant as jq
from distributed_tensorflow_guide_tpu.serve import Request as JRequest
from distributed_tensorflow_guide_tpu.serve import ServeEngine as JServeEngine
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.ops import quant
from distributed_tensorflow_guide_tpu_torch.parallel import expert as EP
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
)

GEOM = dict(vocab_size=256, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_len=64, causal=True, moe_experts=4, moe_capacity=2)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32),
           np.array([1] * 17, np.int32)]
MAX_NEW = [8, 6, 10]
ROOMY = dict(slots=2, num_blocks=33, block_size=8, prefill_chunk=8)
WD = {8: "int8", 4: "int4", "fp8": "fp8"}


def _tree(params):
    return jax.tree.map(np.asarray, fnn.meta.unbox(params))


def _bytes(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


@pytest.fixture(scope="module")
def jparams():
    return jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def model(jparams):
    m = ttf.Transformer(TCFG)
    m.load_state_dict(bridge.params_from_flax(_tree(jparams), TCFG))
    return m.eval()


def _key(i):
    return np.array([0, 100 + i], np.uint32)  # == jax.random.PRNGKey(100+i)


# ---- MoEMLP against the reference -------------------------------------------


def _mlp_pair(capacity, seed=0):
    """The reference MoEMLP's params and the port's module on them."""
    jcfg = dataclasses.replace(JCFG, moe_capacity=capacity)
    tcfg = dataclasses.replace(TCFG, moe_capacity=capacity)
    x0 = jnp.zeros((1, 1, GEOM["d_model"]), jnp.float32)
    p = _tree(jtf.MoEMLP(jcfg).init(jax.random.PRNGKey(seed), x0)["params"])
    # spread the router so that several tokens contend for one expert
    p["router"]["kernel"] = (np.random.RandomState(seed).randn(
        *p["router"]["kernel"].shape) * 0.5).astype(np.float32)
    mlp = ttf.MoEMLP(tcfg)
    with torch.no_grad():
        mlp.router.weight.copy_(torch.tensor(p["router"]["kernel"].T))
        mlp.w_in.weight.copy_(torch.tensor(p["w_in"]["kernel"]))
        mlp.w_out.weight.copy_(torch.tensor(p["w_out"]["kernel"]))
    return jcfg, p, mlp


@pytest.mark.parametrize("capacity", [None, 1, 2])
@pytest.mark.parametrize("shape", [(8, 1), (2, 6)], ids=["decode", "chunk"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_moe_mlp_matches_the_reference(capacity, shape, masked):
    jcfg, p, mlp = _mlp_pair(capacity)
    rs = np.random.RandomState(1)
    x = rs.randn(*shape, GEOM["d_model"]).astype(np.float32)
    mask = (rs.rand(*shape) > 0.3) if masked else None
    y, stats = jtf.MoEMLP(jcfg).apply(
        {"params": p}, jnp.asarray(x),
        moe_mask=None if mask is None else jnp.asarray(mask),
        mutable=["moe_stats"])
    census = []
    with torch.no_grad():
        got = mlp(torch.from_numpy(x),
                  None if mask is None else torch.from_numpy(mask), census)
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=0,
                               atol=1e-5)
    load, overflow, of_tok = ttf.moe_census_sum(census)
    s = stats["moe_stats"]
    assert load.tolist() == np.asarray(s["load"][0]).astype(int).tolist()
    assert overflow.tolist() == np.asarray(
        s["overflow"][0]).astype(int).tolist()
    assert of_tok.tolist() == np.asarray(
        s["overflow_tok"][0]).astype(int).tolist()
    if capacity == 1 and shape == (8, 1) and not masked:
        assert overflow.sum() > 0  # the case exercises drops
        dropped = of_tok.bool().reshape(shape)
        assert torch.all(got[dropped] == 0)  # a dropped token gets 0


@pytest.mark.parametrize("top_k,capacity,masked", [
    (1, 16, False), (1, 3, False), (1, 3, True), (2, 5, False),
    (2, 16, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_dispatch_is_bitwise_the_one_hot_plain_version(
        top_k, capacity, masked, dtype):
    rs = np.random.RandomState(2)
    t, e, d = 16, 4, 8
    gates = torch.softmax(torch.from_numpy(rs.randn(t, e) * 2).float(), -1)
    x = torch.from_numpy(rs.randn(t, d).astype(np.float32)).to(dtype)
    mask = torch.from_numpy(rs.rand(t) > 0.3) if masked else None
    r = EP.route(gates, top_k, capacity, mask)
    disp, comb = EP.route_onehot(gates, top_k, capacity, mask)
    buf = EP.dispatch(x, r)
    assert torch.equal(buf.view(e, capacity, d),
                       torch.einsum("tec,td->ecd", disp.to(dtype), x))
    out = torch.from_numpy(rs.randn(e * capacity, d).astype(np.float32))
    got = EP.combine(out.to(dtype), r, dtype)
    want = torch.einsum("tec,ecd->td", comb.to(dtype).float(),
                        out.to(dtype).view(e, capacity, d).float()).to(dtype)
    if top_k == 1 or dtype == torch.bfloat16:
        # one product, or two exact bf16 x bf16 products summed once
        assert torch.equal(got, want)
    else:  # two rounded f32 products: a fused multiply-add rounds once
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    kept = disp.sum(dim=-1)
    assert r.load.tolist() == kept.sum(dim=0).long().tolist()
    routed = top_k * (t if mask is None else int(mask.sum()))
    assert int(r.load.sum() + r.overflow.sum()) == routed


def test_moe_transformer_logits_and_greedy_tokens_match_the_reference(
        jparams, model):
    x = np.random.RandomState(3).randint(0, 256, (2, 12)).astype(np.int32)
    want = np.asarray(jtf.Transformer(JCFG).apply({"params": jparams},
                                                  jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # one request's greedy stream (the engine test below takes all three)
    p, mn = PROMPTS[1], MAX_NEW[1]
    assert _tone_shot(TCFG, model, p, mn, 1) == _jone_shot(JCFG, jparams,
                                                           p, mn, 1)


@pytest.mark.parametrize("kw,err", [
    (dict(moe_capacity=2), "moe_capacity requires moe_experts"),
    (dict(moe_experts=1), "moe_experts must be >= 2"),
    (dict(moe_experts=4, moe_capacity=0), "moe_capacity must be >= 1"),
    (dict(moe_experts=4, lora_rank=2, lora_adapters=1),
     "moe_experts and lora_rank"),
    (dict(moe_experts=4, quantized_matmuls=True),
     "moe_experts and the training quant levers"),
    (dict(moe_experts=4, fp8_matmuls=True),
     "moe_experts and the training quant levers"),
    (dict(moe_experts=4, tp_axis="model"), "moe_experts and tp_axis"),
])
def test_config_validation_is_the_references(kw, err):
    base = {k: v for k, v in GEOM.items()
            if k not in ("moe_experts", "moe_capacity")}
    with pytest.raises(ValueError, match=err):
        jtf.TransformerConfig(**base, **kw)
    with pytest.raises(ValueError, match=err):
        ttf.TransformerConfig(**base, **kw)


def test_moe_property_and_views():
    assert TCFG.moe and not dataclasses.replace(
        TCFG, moe_experts=None, moe_capacity=None).moe
    assert ttf.moe_capacity(TCFG, 8, 1) == 2       # decode: the knob
    assert ttf.moe_capacity(TCFG, 2, 9) == 18      # multi-token: dropless
    assert ttf.moe_capacity(dataclasses.replace(TCFG, moe_capacity=None),
                            8, 1) == 8


# ---- quantised banks --------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
def test_quantize_params_folds_the_banks_as_the_reference(jparams, model,
                                                          bits):
    cfg = dataclasses.replace(TCFG, weight_dtype=WD[bits])
    bridged = bridge.params_from_flax(
        _tree(jq.quantize_params(jparams, bits=bits)), cfg)
    mine = quant.quantize_params(model.state_dict(), bits=bits)
    assert sorted(bridged) == sorted(mine)
    for k in bridged:
        assert bridged[k].dtype == mine[k].dtype, k
        assert np.array_equal(_bytes(bridged[k]), _bytes(mine[k])), k
    assert mine["blocks.0.mlp.router.weight"].dtype == torch.float32
    assert mine["blocks.0.mlp.w_in.qkernel"].shape[0] == 4
    assert mine["blocks.0.mlp.w_in.scale"].shape == (4, GEOM["d_ff"])
    qm = ttf.Transformer(cfg)
    qm.load_state_dict(bridged)
    x = np.random.RandomState(4).randint(0, 256, (1, 9)).astype(np.int32)
    want = np.asarray(jtf.Transformer(dataclasses.replace(
        JCFG, weight_dtype=WD[bits])).apply(
        {"params": jq.quantize_params(jparams, bits=bits)}, jnp.asarray(x)))
    with torch.no_grad():
        got = qm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bridge_round_trips_the_moe_leaves(jparams, model):
    back = bridge.params_to_flax(model.state_dict(), TCFG)
    for path, leaf in jax.tree_util.tree_leaves_with_path(_tree(jparams)):
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, leaf), path


# ---- serving ----------------------------------------------------------------


def _jone_shot(cfg, prm, prompt, max_new, i, temp=0.0, top_k=None):
    gen = jgen.make_generate_fn(cfg, max_new_tokens=max_new,
                                temperature=temp, top_k=top_k)
    out = gen(prm, prompt[None], jax.random.PRNGKey(100 + i))
    return np.asarray(out)[0, len(prompt):].tolist()


def _tone_shot(cfg, m, prompt, max_new, i, temp=0.0, top_k=None):
    gen = tgen.make_generate_fn(cfg, max_new_tokens=max_new,
                                temperature=temp, top_k=top_k, device="cpu")
    return gen(m, prompt[None], _key(i))[0, len(prompt):].tolist()


def _serve(cfg, m, *, temp=0.0, top_k=None, prompts=PROMPTS,
           max_new=MAX_NEW, **kw):
    eng = ServeEngine(cfg, m, temperature=temp, top_k=top_k, device="cpu",
                      **{**ROOMY, **kw})
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i)))
    eng.run()
    eng.sched.pool.check_leaks()
    return eng


def test_one_shot_prefill_is_dropless_and_a_solo_decode_never_overflows(
        model, monkeypatch):
    """The generator runs the MoE model unchanged: the prompt chunk seats
    every token (C = T), each decode step seats ``moe_capacity``, and one
    request alone (B = 1) never overflows; two requests at capacity 1 do."""
    seen = []

    def route(gates, top_k, capacity, mask=None):
        r = real(gates, top_k, capacity, mask)
        seen.append((gates.shape[0], capacity, int(r.overflow.sum())))
        return r

    real = EP.route
    monkeypatch.setattr(EP, "route", route)
    cap1 = dataclasses.replace(TCFG, moe_capacity=1)
    p = PROMPTS[1]
    _tone_shot(cap1, model, p, 6, 0)
    L = TCFG.num_layers
    assert seen[:L] == [(len(p), len(p), 0)] * L  # the prompt: dropless
    assert seen[L:] == [(1, 1, 0)] * (5 * L)      # decode: capacity 1
    seen.clear()
    gen = tgen.make_generate_fn(cap1, max_new_tokens=6, temperature=0.0,
                                device="cpu")
    gen(model, np.stack([p, p[::-1]]), _key(0))
    assert any(of for _, _, of in seen[2 * L:])   # a batch of 2 overflows


@pytest.mark.parametrize("temp,top_k", [(0.0, None), (0.8, 10)],
                         ids=["greedy", "sampled"])
def test_moe_engine_equals_solo_one_shot_bitwise(model, temp, top_k):
    """tests/test_serving.py:1489 on the port: every stream bitwise the
    request's solo one-shot run (one token a step: never overflows)."""
    eng = _serve(TCFG, model, temp=temp, top_k=top_k)
    got = eng.completions()
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        assert got[i] == _tone_shot(TCFG, model, p, mn, i, temp, top_k), i
    assert eng.sched.done == {0, 1, 2} and eng.live_blocks() == 0
    assert eng.fns.captures == {"decode": 0, "prefill": 0}  # the CPU


def test_moe_parity_through_eviction(model):
    prompts = [np.array([3, 5, 7, 9, 11], np.int32),
               np.array([2, 4, 6, 8, 10, 12, 14], np.int32)]
    max_new = [40, 40]
    eng = _serve(TCFG, model, temp=0.7, top_k=12, prompts=prompts,
                 max_new=max_new, num_blocks=9)
    assert eng.sched.preemptions >= 1
    got = eng.completions()
    for i in range(2):
        assert got[i] == _tone_shot(TCFG, model, prompts[i], max_new[i], i,
                                    0.7, 12), i


def test_moe_capacity_one_stalls_and_the_census_balances(model):
    """tests/test_serving.py:1551 on the port: capacity 1 with two live
    slots stalls, streams stay bitwise the solo runs', and every routed
    token-slot is seated or overflowed: sum(load) + sum(overflow) ==
    L * (prompt tokens + (max_new - 1) decode ticks + stalled ticks)."""
    cap1 = dataclasses.replace(TCFG, moe_capacity=1)
    eng = _serve(cap1, model, temp=0.8, top_k=10)
    got = eng.completions()
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        assert got[i] == _tone_shot(cap1, model, p, mn, i, 0.8, 10), i
    moe = eng.health()["moe"]
    assert sorted(moe) == ["expert_load", "expert_overflow",
                           "stall_slot_ticks", "stall_ticks"]
    assert moe["stall_slot_ticks"] >= 1 and moe["stall_ticks"] >= 1
    assert sum(moe["expert_overflow"]) >= moe["stall_slot_ticks"]
    routed = (sum(len(p) for p in PROMPTS) + sum(mn - 1 for mn in MAX_NEW)
              + moe["stall_slot_ticks"])
    assert (sum(moe["expert_load"]) + sum(moe["expert_overflow"])
            == TCFG.num_layers * routed)


def test_moe_int8_banks_through_the_engine(jparams, model):
    """tests/test_serving.py:1527 on the port: int8 banks, the engine
    bitwise its one-shot on the same quantised model (sampled), and the
    greedy one-shot the reference's on its quantised tree."""
    qm = model.quantize("int8")
    cfg = qm.cfg
    eng = _serve(cfg, qm, temp=0.8, top_k=10)
    got = eng.completions()
    qp = jq.quantize_params(jparams, bits=8)
    jcfg = dataclasses.replace(JCFG, weight_dtype="int8")
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        assert got[i] == _tone_shot(cfg, qm, p, mn, i, 0.8, 10), i
    p, mn = PROMPTS[2], MAX_NEW[2]
    assert _tone_shot(cfg, qm, p, mn, 2) == _jone_shot(jcfg, qp, p, mn, 2)
    assert qm.blocks[0].mlp.w_in.qkernel.dtype == torch.int8
    assert qm.blocks[0].mlp.router.weight.dtype == torch.float32


def test_moe_greedy_engine_equals_the_reference_engine(jparams, model):
    jeng = JServeEngine(JCFG, jparams, temperature=0.0, top_k=None, **ROOMY)
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn,
                             rng=jax.random.PRNGKey(100 + i)))
    jeng.run()
    eng = _serve(TCFG, model)
    assert eng.completions() == jeng.completions()
    assert eng.steps == jeng.steps
    assert eng.health()["moe"] == jeng.health()["moe"]
