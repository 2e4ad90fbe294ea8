"""The port's multi-LoRA serving held to the JAX package's: the config,
the delta banks and their bridge, logits, the one-shot generator's
``adapters``/``adapter_id`` and the engine's per-slot adapters.

One model: the serve CLI's geometry (vocab 256, 2 layers, 2 heads,
d_model 32, d_ff 64, max_len 64, float32) with ``lora_rank=2``,
``lora_adapters=2``; the JAX weights and a random bank (numpy, seeded;
row 0 zero) bridged into the port. Logits agree within 2e-5 absolute and
1e-5 relative (float32; the frameworks sum in other orders); tokens are
compared bitwise. The reference's control test ("adapter 1 changes the
stream" at a 0.05-scaled rank-2 delta) fails in the JAX package itself
and is not copied: the control here measures the logits a delta moves
and uses a scale shown to move the tokens.
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
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
    adapter_bank_shapes,
    init_adapter_bank,
)

GEOM = dict(vocab_size=256, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_len=64, causal=True)
LORA = dict(lora_rank=2, lora_adapters=2)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32, **LORA)
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
LCFG = dataclasses.replace(TCFG, **LORA)
TOL = dict(atol=2e-5, rtol=1e-5)
PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32),
           np.array([1] * 17, np.int32)]
MAX_NEW = [8, 6, 10]
ENGINE = dict(slots=2, num_blocks=33, block_size=8, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _isolated_table(isolated_autotune_table):
    yield


@pytest.fixture(scope="module")
def jvars():
    return jtf.Transformer(JCFG).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))


@pytest.fixture(scope="module")
def model(jvars):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jvars["params"]))
    m = ttf.Transformer(TCFG)
    m.load_state_dict(bridge.params_from_flax(tree, TCFG))
    return m.eval()


def _bank_tree(jvars, scale, seed=7):
    """A random JAX "adapters" tree: N(0, scale) rows, row 0 zero."""
    rs = np.random.RandomState(seed)

    def leaf(x):
        a = (scale * rs.randn(*x.shape)).astype(np.float32)
        a[0] = 0.0
        return a

    return jax.tree.map(leaf, jax.tree.map(np.asarray, jvars["adapters"]))


@pytest.fixture(scope="module")
def jbank(jvars):
    return _bank_tree(jvars, 0.3)


@pytest.fixture(scope="module")
def bank(jbank):
    return bridge.adapters_from_flax(jbank, LCFG)


def _key(i):
    return np.array([0, 100 + i], np.uint32)  # == jax.random.PRNGKey(100+i)


def _one_shot(model, i, cfg=TCFG, **kw):
    gen = tgen.make_generate_fn(cfg, max_new_tokens=MAX_NEW[i],
                                temperature=0.8, top_k=10, device="cpu",
                                **kw)
    return gen(model, PROMPTS[i][None], _key(i))[0, len(PROMPTS[i]):].tolist()


def _serve(model, cfg, adapters, ids, bank_arg=None, eng=None, rid0=0):
    eng = eng or ServeEngine(cfg, model, temperature=0.8, top_k=10,
                             device="cpu", adapters=bank_arg, **ENGINE)
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        eng.submit(Request(rid=rid0 + i, prompt=p, max_new_tokens=mn,
                           rng=_key(i), adapter=ids[i]))
    eng.run()
    got = eng.completions()
    return eng, [got[rid0 + i] for i in range(len(PROMPTS))]


# ---- the config and the bank -------------------------------------------------


def test_config_validation():
    """The reference's messages, and its mutual exclusions (the excluded
    knobs are not served by the port yet, so LoRA's refusal comes first)."""
    with pytest.raises(ValueError, match="lora_rank must be >= 1"):
        dataclasses.replace(TCFG, lora_rank=0, lora_adapters=1)
    with pytest.raises(ValueError, match="lora_adapters >= 1"):
        dataclasses.replace(TCFG, lora_rank=2)
    with pytest.raises(ValueError, match="lora_adapters requires lora_rank"):
        dataclasses.replace(TCFG, lora_adapters=2)
    with pytest.raises(ValueError, match="weight_dtype and lora_rank"):
        dataclasses.replace(LCFG, weight_dtype="int8")
    with pytest.raises(ValueError, match="moe_experts and lora_rank"):
        dataclasses.replace(LCFG, moe_experts=4)
    assert LCFG.lora and not TCFG.lora


def test_bank_shapes_and_bridge_round_trip(jvars, jbank, bank):
    """The port's bank names and shapes are the JAX collection's, site by
    site and layer by layer, and the bridge is exact both ways."""
    shapes = adapter_bank_shapes(LCFG)
    assert {n: s for n, (s, _) in shapes.items()} == {
        n: tuple(t.shape) for n, t in bank.items()}
    assert len(shapes) == GEOM["num_layers"] * 8
    jshapes = jax.tree.map(lambda x: x.shape, jvars["adapters"])
    assert jshapes == jax.tree.map(lambda x: x.shape, jbank)
    back = bridge.adapters_to_flax(bank, LCFG)
    jax.tree.map(np.testing.assert_array_equal, back, jbank)
    zeros = init_adapter_bank(LCFG)
    assert all(not t.any() for t in zeros.values())
    with pytest.raises(ValueError, match="requires cfg.lora_rank"):
        adapter_bank_shapes(TCFG)


# ---- logits -------------------------------------------------------------------


def test_zero_bank_is_the_base_model_bitwise(model):
    """Row 0 and an all-zero bank add exactly nothing: the LoRA view's
    logits are the base model's, bit for bit, with or without ids."""
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (3, 9)))
    view = model.with_config(LCFG)
    base = model(toks)
    assert torch.equal(view(toks), base)
    assert torch.equal(view(toks, adapter=torch.tensor([0, 1, 2])), base)


def test_lora_logits_match_jax(jvars, jbank, bank, model):
    """Per-request adapters 0, 1, 2 in one batch: the port's logits are the
    JAX package's (2e-5 absolute, 1e-5 relative)."""
    toks = np.random.RandomState(1).randint(0, 256, (3, 9)).astype(np.int32)
    ids = np.array([0, 1, 2], np.int32)
    want = jtf.Transformer(JCFG).apply(
        {"params": jvars["params"], "adapters": jbank}, jnp.asarray(toks),
        adapter=jnp.asarray(ids))
    view = model.with_config(LCFG)
    view.set_adapter_bank(bank)
    got = view(torch.from_numpy(toks), adapter=torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_control_delta_moves_logits_and_tokens(model, bank):
    """A control that the deltas reach the output: at this bank's scale
    (N(0, 0.3) rows) adapter 1 moves the logits by far more than the
    parity tolerance, and its one-shot stream leaves the base stream."""
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (1, 9)))
    view = model.with_config(LCFG)
    view.set_adapter_bank(bank)
    moved = (view(toks, adapter=torch.tensor([1]))
             - view(toks, adapter=torch.tensor([0]))).abs().max().item()
    assert moved > 1e-2
    streams = [_one_shot(model, 1, LCFG, adapters=bank, adapter_id=a)
               for a in (0, 1, 2)]
    assert streams[0] == _one_shot(model, 1)
    assert streams[1] != streams[0] and streams[2] != streams[0]


def test_generator_lora_validation(model, bank):
    with pytest.raises(ValueError, match="pass the adapters bank"):
        tgen.make_generate_fn(LCFG, max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="lora_rank is None"):
        tgen.make_generate_fn(TCFG, max_new_tokens=2, device="cpu",
                              adapters=bank)
    with pytest.raises(ValueError, match="out of range"):
        tgen.make_generate_fn(LCFG, max_new_tokens=2, device="cpu",
                              adapters=bank, adapter_id=3)


# ---- the engine ---------------------------------------------------------------


def test_engine_adapters_equal_one_shots_and_the_jax_engine(jvars, jbank,
                                                            bank, model):
    """Three requests on adapters 0, 1, 2 share the decode steps: adapter
    0's stream is the base one-shot's, adapter k's the one-shot's with
    ``adapter_id=k``, bitwise; and every stream is the JAX engine's for
    the same bank (temperature 0.8, top-k 10)."""
    ids = [0, 1, 2]
    eng, got = _serve(model, LCFG, bank, ids, bank_arg=bank)
    assert got[0] == _one_shot(model, 0)
    for i in (1, 2):
        assert got[i] == _one_shot(model, i, LCFG, adapters=bank,
                                   adapter_id=ids[i]), i
    jeng = JServeEngine(JCFG, jvars["params"], temperature=0.8, top_k=10,
                        adapters=jbank, **ENGINE)
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn,
                             rng=jax.random.PRNGKey(100 + i),
                             adapter=ids[i]))
    jeng.run()
    jgot = jeng.completions()
    assert got == [jgot[i] for i in range(3)]
    assert eng.steps == jeng.steps
    eng.sched.pool.check_leaks()


def test_engine_bank_rewritten_in_place(model, bank, jvars):
    """A zero bank at construction serves the base model on every id;
    ``load_adapter_bank`` writes new weights into the same tensors, and
    the next requests follow them."""
    eng, first = _serve(model, LCFG, None, [1, 2, 0])
    live = {n: t.data_ptr() for n, t in eng.adapters.items()}
    assert first == [_one_shot(model, i) for i in range(3)]
    eng.load_adapter_bank(bank)
    assert {n: t.data_ptr() for n, t in eng.adapters.items()} == live
    _, second = _serve(model, LCFG, None, [1, 2, 0], eng=eng, rid0=10)
    assert second[0] == _one_shot(model, 0, LCFG, adapters=bank,
                                  adapter_id=1)
    assert second[2] == first[2]
    eng.sched.pool.check_leaks()


def test_engine_lora_validation(model, bank):
    eng = ServeEngine(LCFG, model, device="cpu", adapters=bank, **ENGINE)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(Request(rid=0, prompt=PROMPTS[0], max_new_tokens=2,
                           rng=_key(0), adapter=3))
    base = ServeEngine(TCFG, model, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="no lora_rank"):
        base.submit(Request(rid=0, prompt=PROMPTS[0], max_new_tokens=2,
                            rng=_key(0), adapter=1))
    with pytest.raises(ValueError, match="serves no adapters"):
        base.load_adapter_bank(bank)
    with pytest.raises(ValueError, match="shape"):
        ServeEngine(LCFG, model, device="cpu", **ENGINE,
                    adapters={n: t[:1] for n, t in bank.items()})
