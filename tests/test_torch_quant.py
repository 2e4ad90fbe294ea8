"""The port's quantisation (``ops/quant.py``, ``weight_dtype``, the
``int8`` / ``fp8`` presets, ``compress="int8"``) held to the JAX package's
``ops/quant.py`` on the same inputs, on the CPU.

Tolerances:

* ``quantize_channelwise`` values and scales (8, 4 bits, fp8),
  ``pack_int4`` / ``unpack_int4``, ``quantize_params`` through the weight
  bridge: bitwise (both round half to even; the fp8 cast clamps first);
* ``int8_ste_dot``'s int32 sums: bitwise (exact integer sums);
  its f32 output and ``fp8_ste_dot``'s: within 1e-6 of the reference's
  (e4m3 products are exact in f32; only the order of the f32 sums may
  differ); straight-through gradients: bitwise the port's unquantised
  product's, within 1e-6 of the reference's VJP;
* ``wq_matmul`` / ``wq_bank_matmul`` and the quantised model's logits:
  f32 atol 1e-5;
* serving: greedy tokens identical to the reference's (wq8 also to the
  f32 model's), the engine bitwise the one-shot; wq4 logits within the
  reference's 0.05 of f32;
* the ``int8`` / ``fp8`` presets: the first step's loss within 1e-6 of
  the reference's under the same preset (relative), every step's within
  1e-3 (an f32-ulp gap in a weight may move an element across a rounding
  boundary of the quantiser), and the reference's own bands against
  ``f32`` (5e-3 int8, 2e-2 fp8);
* ``int8_pmean`` at 2 gloo ranks: the reference's values within 1e-6 and
  its wire bytes exactly; ``compress="int8"`` on the bucketed step: the
  reference's parity bands against the plain step and 1 byte an element
  plus one 4-byte scale a bucket on the wire.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state
from jax.sharding import Mesh

import distributed_tensorflow_guide_tpu.collectives as jcc
from distributed_tensorflow_guide_tpu.core import precision as jprec
from distributed_tensorflow_guide_tpu.core.compat import shard_map
from distributed_tensorflow_guide_tpu.models import generation as jgen
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.ops import quant as jq
from distributed_tensorflow_guide_tpu.parallel.data_parallel import (
    DataParallel as JDataParallel,
)
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core import precision
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.ops import quant
from distributed_tensorflow_guide_tpu_torch.runtime import multiprocess as mp
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
)
from jax.sharding import PartitionSpec as P
from tests import torch_mp_workers as W

GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=16, d_ff=32,
            max_len=64, causal=True)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
BITS = [8, 4, "fp8"]
WD = {8: "int8", 4: "int4", "fp8": "fp8"}


def _bytes(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jbytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


@pytest.fixture(scope="module")
def jparams():
    return jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def model(jparams):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    m = ttf.Transformer(TCFG)
    m.load_state_dict(bridge.params_from_flax(tree, TCFG))
    return m.eval()


def _kernel(seed=0, shape=(64, 32)):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    w[:, 3] = 0.0          # a zero column: scale 1, exact zeros
    w[5, 7] = 1e4          # one column dominated by an outlier
    return w


# ---- the storage-side primitives, bitwise -----------------------------------


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(64, 32), (768, 24), (6, 5)])
def test_quantize_channelwise_is_bitwise_the_reference(bits, shape):
    w = _kernel(1, shape) if shape[1] > 7 else np.random.RandomState(
        2).randn(*shape).astype(np.float32)
    qj, sj = jq.quantize_channelwise(jnp.asarray(w), bits=bits)
    qt, st = quant.quantize_channelwise(torch.from_numpy(w), bits=bits)
    want = torch.float8_e4m3fn if bits == "fp8" else torch.int8
    assert qt.dtype == want and st.dtype == torch.float32
    assert np.array_equal(_bytes(qt), _jbytes(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_roundtrip_error_bound(bits):
    w = _kernel(0)
    q, scale = quant.quantize_channelwise(torch.from_numpy(w), bits=bits)
    assert int(q.abs().max()) <= quant.QMAX[bits]
    back = quant.dequantize_channelwise(q, scale).numpy()
    assert np.all(np.abs(back - w) <= scale.numpy()[None, :] / 2 + 1e-7)
    assert float(scale[3]) == 1.0 and np.all(back[:, 3] == 0.0)


def test_pack_unpack_int4_bitwise():
    grid = torch.arange(-8, 8, dtype=torch.int8).reshape(16, 1)
    assert torch.equal(quant.unpack_int4(quant.pack_int4(grid)), grid)
    q = np.random.RandomState(1).randint(-7, 8, (64, 5)).astype(np.int8)
    packed = quant.pack_int4(torch.from_numpy(q))
    assert packed.shape == (32, 5) and packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(),
                          np.asarray(jq.pack_int4(jnp.asarray(q))))
    assert np.array_equal(quant.unpack_int4(packed).numpy(), q)
    assert np.array_equal(
        quant.unpack_int4(packed).numpy(),
        np.asarray(jq.unpack_int4(jq.pack_int4(jnp.asarray(q)))))
    with pytest.raises(ValueError, match="even leading axis"):
        quant.pack_int4(torch.from_numpy(q[:63]))


def test_fp8_cast_saturates_where_torch_would_not():
    x = torch.tensor([1e4, 500.0, 448.0, -1e9, float("inf"), 3.0])
    got = quant.to_fp8(x).float()
    assert got.tolist() == [448.0, 448.0, 448.0, -448.0, 448.0, 3.0]


def test_check_bits_error_names_fp8():
    with pytest.raises(ValueError, match="fp8"):
        quant.quantize_channelwise(torch.ones(4, 4), bits=3)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows", [4, 1])
def test_wq_matmul_matches_the_reference(bits, rows):
    rng = np.random.RandomState(2)
    x = rng.randn(rows, 64).astype(np.float32)
    w = rng.randn(64, 32).astype(np.float32)
    qj, sj = jq.quantize_channelwise(jnp.asarray(w), bits=bits)
    qt, st = quant.quantize_channelwise(torch.from_numpy(w), bits=bits)
    if bits == 4:
        qj, qt = jq.pack_int4(qj), quant.pack_int4(qt)
    want = np.asarray(jq.wq_matmul(jnp.asarray(x), qj, sj, bits=bits))
    got = quant.wq_matmul(torch.from_numpy(x), qt, st, bits=bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    oracle = x @ quant.dequantize_channelwise(
        quant.unpack_int4(qt) if bits == 4 else qt, st).numpy()
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", BITS)
def test_wq_bank_matmul_matches_the_reference(bits):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 16).astype(np.float32)
    bank = rng.randn(3, 16, 8).astype(np.float32)
    qj, sj = jax.vmap(lambda k: jq.quantize_channelwise(k, bits=bits))(
        jnp.asarray(bank))
    qs = [quant.quantize_channelwise(torch.from_numpy(b), bits=bits)
          for b in bank]
    qt = torch.stack([q for q, _ in qs])
    st = torch.stack([s for _, s in qs])
    if bits == 4:
        qj = jax.vmap(jq.pack_int4)(qj)
        qt = torch.stack([quant.pack_int4(q) for q in qt])
    assert np.array_equal(_bytes(qt), _jbytes(qj))
    want = np.asarray(jq.wq_bank_matmul(jnp.asarray(x), qj, sj, bits=bits))
    got = quant.wq_bank_matmul(torch.from_numpy(x), qt, st, bits=bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---- the training products ---------------------------------------------------


def test_int8_ste_dot_int32_sums_are_bitwise_the_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    qxj, sxj = jq._dynamic_quant(jnp.asarray(x))
    qwj, swj = jq._dynamic_quant(jnp.asarray(w))
    acc_j = jax.lax.dot_general(qxj, qwj, (((2,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    qxt, sxt = quant._dynamic_quant(torch.from_numpy(x))
    qwt, swt = quant._dynamic_quant(torch.from_numpy(w))
    assert np.array_equal(qxt.numpy(), np.asarray(qxj))
    assert np.array_equal(qwt.numpy(), np.asarray(qwj))
    assert float(sxt) == float(sxj) and float(swt) == float(swj)
    acc_t = quant.int8_mm(qxt.reshape(-1, 16), qwt)
    assert acc_t.dtype == torch.int32
    assert np.array_equal(acc_t.reshape(2, 4, 8).numpy(), np.asarray(acc_j))
    got = quant.int8_ste_dot(torch.from_numpy(x), torch.from_numpy(w))
    want = jq.int8_ste_dot(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_fp8_ste_dot_matches_the_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    got = quant.fp8_ste_dot(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(jq.fp8_ste_dot(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert float(np.abs(got.numpy() - x @ w).max()
                 / np.abs(x @ w).max()) < 0.15


@pytest.mark.parametrize("name", ["int8_ste_dot", "fp8_ste_dot"])
def test_ste_gradients_are_the_unquantised_products(name):
    rng = np.random.RandomState(4)
    x = rng.randn(4, 16).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    ct = rng.randn(4, 8).astype(np.float32)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    getattr(quant, name)(xt, wt).backward(torch.from_numpy(ct))
    xf, wf = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (xf @ wf).backward(torch.from_numpy(ct))
    assert torch.equal(xt.grad, xf.grad) and torch.equal(wt.grad, wf.grad)
    _, vjp = jax.vjp(getattr(jq, name), jnp.asarray(x), jnp.asarray(w))
    for got, want in zip((xt.grad, wt.grad), vjp(jnp.asarray(ct))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_int8_mm_takes_int8_only():
    with pytest.raises(TypeError, match="int8"):
        quant.int8_mm(torch.ones(4, 4), torch.ones(4, 4))
    with pytest.raises(TypeError, match="e4m3"):
        quant.fp8_mm(torch.ones(4, 4), torch.ones(4, 4))


# ---- quantize_params through the bridge --------------------------------------


@pytest.mark.parametrize("bits", BITS)
def test_quantize_params_through_the_bridge_gives_the_same_bytes(
        jparams, model, bits):
    """The reference's quantised tree, bridged, and the port's
    ``quantize_params`` of the bridged f32 weights: the same entries, the
    same bytes."""
    cfg = dataclasses.replace(TCFG, weight_dtype=WD[bits])
    tree = jax.tree.map(np.asarray,
                        fnn.meta.unbox(jq.quantize_params(jparams,
                                                          bits=bits)))
    bridged = bridge.params_from_flax(tree, cfg)
    mine = quant.quantize_params(model.state_dict(), bits=bits)
    assert sorted(bridged) == sorted(mine)
    for k in bridged:
        assert bridged[k].dtype == mine[k].dtype, k
        assert np.array_equal(_bytes(bridged[k]), _bytes(mine[k])), k
    qm = ttf.Transformer(cfg)
    qm.load_state_dict(bridged)  # the module's own layout
    assert sorted(qm.state_dict()) == sorted(mine)


@pytest.mark.parametrize("bits", BITS)
def test_quantised_logits_match_the_reference(jparams, model, bits):
    x = np.array([[3, 5, 7, 9, 11, 2, 4, 6]], np.int32)
    cfg = dataclasses.replace(JCFG, weight_dtype=WD[bits])
    want = np.asarray(jtf.Transformer(cfg).apply(
        {"params": jq.quantize_params(jparams, bits=bits)}, jnp.asarray(x)))
    qm = model.quantize(WD[bits])
    with torch.no_grad():
        got = qm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if bits == 4:  # the reference's int4 band against f32
        with torch.no_grad():
            f32 = model(torch.from_numpy(x)).numpy()
        assert np.abs(got - f32).max() < 0.05


def test_quantised_model_refuses_training_and_requantising(model):
    qm = model.quantize("int8")
    with pytest.raises(ValueError, match="serving config"):
        ttf.make_lm_loss_fn(qm)
    with pytest.raises(ValueError, match="quantised already"):
        qm.quantize("int4")
    assert not list(p for n, p in qm.named_parameters()
                    if n.endswith(("qkernel", "scale")))


# ---- serving ------------------------------------------------------------------

PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32)]
MAX_NEW = [8, 6]


def _key(i):
    return np.array([0, 100 + i], np.uint32)


def _jone_shot(cfg, prm, prompt, max_new):
    gen = jgen.make_generate_fn(cfg, max_new_tokens=max_new,
                                temperature=0.0, top_k=None)
    out = gen(prm, prompt[None], jax.random.PRNGKey(100))
    return np.asarray(out)[0, len(prompt):].tolist()


def _tone_shot(cfg, m, prompt, max_new):
    gen = tgen.make_generate_fn(cfg, max_new_tokens=max_new,
                                temperature=0.0, top_k=None, device="cpu")
    return gen(m, prompt[None], _key(0))[0, len(prompt):].tolist()


def _engine(cfg, m):
    eng = ServeEngine(cfg, m, temperature=0.0, top_k=None, slots=2,
                      num_blocks=17, block_size=8, prefill_chunk=8,
                      device="cpu")
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i)))
    eng.run()
    eng.sched.pool.check_leaks()
    return eng.completions()


@pytest.mark.parametrize("bits", BITS)
def test_quantised_engine_matches_one_shot_and_reference(
        jparams, model, bits, monkeypatch):
    """tests/test_quant.py:222 on the port: the engine on the quantised
    model equals its own one-shot bitwise, and each greedy stream equals
    the reference's one-shot on its quantised tree; wq8 also the f32
    model's stream."""
    monkeypatch.setenv(precision.FP8_EMULATE_ENV, "1")
    cfg = dataclasses.replace(TCFG, weight_dtype=WD[bits])
    jcfg = dataclasses.replace(JCFG, weight_dtype=WD[bits])
    qm = model.quantize(WD[bits])
    qp = jq.quantize_params(jparams, bits=bits)
    got = _engine(cfg, qm)
    for i, (p, mn) in enumerate(zip(PROMPTS, MAX_NEW)):
        assert got[i] == _tone_shot(cfg, qm, p, mn), f"req {i}"
        assert got[i] == _jone_shot(jcfg, qp, p, mn), f"req {i} vs jax"
        if bits == 8:
            assert got[i] == _jone_shot(JCFG, jparams, p, mn), f"{i} f32"


def test_fp8_engine_is_gated_on_the_card_capability(model, monkeypatch):
    monkeypatch.delenv(precision.FP8_EMULATE_ENV, raising=False)
    cfg = dataclasses.replace(TCFG, weight_dtype="fp8")
    with pytest.raises(ValueError, match=precision.FP8_EMULATE_ENV):
        ServeEngine(cfg, model.quantize("fp8"), slots=2, num_blocks=17,
                    block_size=8, prefill_chunk=8, device="cpu")


# ---- the config and policy contracts ------------------------------------------


def test_config_exclusions():
    for bad, match in (
            (dict(weight_dtype="e5m2"), "weight_dtype"),
            (dict(weight_dtype="int8", quantized_matmuls=True), "exclusive"),
            (dict(weight_dtype="fp8", fp8_matmuls=True), "exclusive"),
            (dict(quantized_matmuls=True, fp8_matmuls=True), "exclusive"),
            (dict(quantized_matmuls=True, decode=True), "training lever"),
            (dict(fp8_matmuls=True, lora_rank=2, lora_adapters=1),
             "lora_rank"),
            (dict(weight_dtype="int4", lora_rank=2, lora_adapters=1),
             "mutually exclusive")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(TCFG, **bad)
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(JCFG, **bad)
    for ok in (dict(weight_dtype="fp8"), dict(fp8_matmuls=True),
               dict(quantized_matmuls=True), dict(weight_dtype="int4",
                                                   decode=True)):
        dataclasses.replace(TCFG, **ok)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantised_presets_match_the_reference(name):
    pol, jpol = precision.resolve(name), jprec.resolve(name)
    assert (pol.quantized_matmuls, pol.fp8_matmuls) == (
        jpol.quantized_matmuls, jpol.fp8_matmuls)
    assert pol.compute_dtype == torch.float32
    cfg = pol.apply_to_transformer(TCFG)
    assert cfg.train_quant == name and cfg.dtype == torch.float32
    with pytest.raises(ValueError, match="exclusive"):
        precision.Policy("both", quantized_matmuls=True, fp8_matmuls=True)


def _mock_card(monkeypatch, capability):
    monkeypatch.delenv(precision.FP8_EMULATE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: capability)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: f"card sm_{capability[0]}"
                                       f"{capability[1]}")


@pytest.mark.parametrize("capability,capable", [
    ((9, 0), True), ((10, 0), True), ((8, 9), False), ((8, 0), False)])
def test_fp8_capability_keys_on_compute_capability(monkeypatch, capability,
                                                   capable):
    _mock_card(monkeypatch, capability)
    assert precision.fp8_capable("cuda:0") is capable
    if capable:
        precision.require_fp8("cuda:0")
    else:
        with pytest.raises(ValueError) as ei:
            precision.require_fp8("cuda:0")
        msg = str(ei.value)
        assert "emulat" in msg and "bf16" in msg
        assert precision.FP8_EMULATE_ENV in msg


def test_fp8_capability_on_the_cpu_and_the_emulate_env(monkeypatch):
    monkeypatch.delenv(precision.FP8_EMULATE_ENV, raising=False)
    assert not precision.fp8_capable("cpu")
    with pytest.raises(ValueError, match="cpu"):
        precision.require_fp8("cpu")
    monkeypatch.setenv(precision.FP8_EMULATE_ENV, "1")
    assert precision.fp8_capable("cpu")
    precision.require_fp8("cpu")
    monkeypatch.setenv(precision.FP8_EMULATE_ENV, "0")
    assert not precision.fp8_capable("cpu")


# ---- the int8 / fp8 presets train like the reference -------------------------


def _jtrain(cfg, steps=5):
    model = jtf.Transformer(cfg)
    prm = model.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 8), jnp.int32))["params"]
    tx = optax.adam(1e-2)
    opt = tx.init(prm)
    xs = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (steps, 4, 8)).astype(np.int32)

    @jax.jit
    def step(prm, opt, x):
        def loss_fn(p):
            lp = jax.nn.log_softmax(model.apply({"params": p}, x[:, :-1]), -1)
            return -jnp.mean(jnp.take_along_axis(lp, x[:, 1:, None], -1))

        loss, g = jax.value_and_grad(loss_fn)(prm)
        up, opt = tx.update(g, opt, prm)
        return optax.apply_updates(prm, up), opt, loss

    out = []
    for x in xs:
        prm, opt, loss = step(prm, opt, x)
        out.append(float(loss))
    return prm, out


def _ttrain(cfg, jparams0, steps=5):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams0))
    m = ttf.Transformer(cfg)
    m.load_state_dict(bridge.params_from_flax(tree, cfg))
    opt = torch.optim.Adam(m.parameters(), lr=1e-2, eps=1e-8)
    xs = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (steps, 4, 8)).astype(np.int64)
    out = []
    for x in xs:
        x = torch.from_numpy(x)
        logits = m(x[:, :-1])
        lp = torch.log_softmax(logits, -1)
        loss = -lp.gather(-1, x[:, 1:, None]).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        out.append(loss.item())
    return out


@pytest.mark.parametrize("name,band", [("int8", 5e-3), ("fp8", 2e-2)])
def test_quantised_preset_losses_match_the_reference(name, band):
    """tests/test_quant.py:292 and tests/test_fp8.py:169 on the port: the
    preset's five Adam steps from the same bridged weights give the
    reference's losses under the same preset, and stay in the
    reference's band of the f32 run."""
    small = dataclasses.replace(JCFG, max_len=32)
    tsmall = dataclasses.replace(TCFG, max_len=32)
    jparams0 = jtf.Transformer(small).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]
    _, want = _jtrain(jprec.PRESETS[name].apply_to_transformer(small))
    got = _ttrain(precision.PRESETS[name].apply_to_transformer(tsmall),
                  jparams0)
    # the first step from the same weights agrees to f32 rounding; after
    # it, an f32-ulp gap in a weight can move an element across a
    # rounding boundary of the quantiser, so the steps are held to a
    # fifth of the reference's int8-against-f32 band
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    f32 = _ttrain(precision.PRESETS["f32"].apply_to_transformer(tsmall),
                  jparams0)
    for a, b in zip(f32, got):
        assert abs(a - b) / a < band


# ---- int8_pmean and compress="int8" at 2 gloo ranks ---------------------------


@pytest.fixture(scope="module")
def job():
    ranks = mp.run_multiprocess("tests.torch_mp_workers:quant_job", 2,
                                timeout=300)
    return [r.result for r in ranks]


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.asarray(jax.devices()[:2]), ("data",))


def test_int8_pmean_matches_the_reference_and_its_bytes(job, mesh2):
    trees = [W.qp_tree(i) for i in range(2)]
    glob = {k: np.concatenate([t[k] for t in trees]) for k in trees[0]}
    specs = {k: P("data") for k in glob}
    fn = jax.jit(shard_map(lambda t: jq.int8_pmean(t, "data"), mesh=mesh2,
                           in_specs=(specs,), out_specs=specs,
                           check_vma=False))
    with jcc.trace_comm() as rec:
        jax.eval_shape(fn, glob)
    want = jax.tree.map(np.asarray, fn(glob))
    # per rank: (1, 16, 4) + (1, 4) float elements in int8, one 4-byte scale
    assert dict(rec.bytes) == {"pmax[data]": 4, "psum[data]": 68}
    amax = max(np.abs(glob["w"]).max(), np.abs(glob["b"]).max())
    bound = amax / (127 // 2) / 2 + 1e-7
    for i, r in enumerate(job):
        tr = r["pmean_trace"]
        assert {k: v["bytes"] for k, v in tr.items()} == dict(rec.bytes)
        assert tr["psum[data]"]["calls"] == 1 and tr["pmax[data]"]["calls"] == 1
        assert tr["psum[data]"]["wire"] == 68 * 2 * (2 - 1) / 2
        for k in ("w", "b"):
            got = np.asarray(r["pmean"][k], np.float32)
            np.testing.assert_allclose(got, want[k][i:i + 1], rtol=0,
                                       atol=1e-6)
            exact = glob[k].mean(axis=0, keepdims=True)
            assert np.abs(got - exact).max() <= bound
        assert r["pmean"]["count"] == [i]  # ints pass through
        assert r["ints_trace"] == {}


def _jtoy(mesh2, compress):
    xs, ys = W.qp_problem()
    dp = JDataParallel(mesh2, overlap=True, bucket_bytes=64,
                       compress=compress)
    st = dp.replicate(train_state.TrainState.create(
        apply_fn=None, params={"w": jnp.asarray(W.qp_w0())},
        tx=optax.sgd(W.QP_LR)))

    def loss(params, batch):
        err = batch["x"] @ params["w"] - batch["y"]
        return jnp.mean(err ** 2), {}

    step = dp.make_train_step(loss, donate=False)
    losses = []
    for _ in range(W.QP_STEPS):
        st, m = step(st, dp.shard_batch({"x": xs, "y": ys}))
        losses.append(float(m["loss"]))
    return np.asarray(st.params["w"]), losses


@pytest.mark.parametrize("compress", [None, "int8"])
def test_dp_steps_match_the_reference(job, mesh2, compress):
    w, losses = _jtoy(mesh2, compress)
    name = "int8" if compress else "plain"
    for r in job:
        got = r[f"dp/{name}"]
        np.testing.assert_allclose(np.asarray(got["w"]), w, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose([x[0] for x in got["losses"]], losses,
                                   rtol=1e-5)


def test_dp_compress_parity_and_wire_bytes(job):
    """tests/test_quant.py:386 on the port: the compressed run tracks the
    plain one, and the wire swaps the f32 bucket (4 bytes an element) for
    an int8 psum (1 byte) plus a 4-byte scale pmax; the metric pmean is
    the same on both sides."""
    dim = W.QP_DIM
    for r in job:
        c, p = r["dp/int8"], r["dp/plain"]
        assert c["losses"][-1][0] == pytest.approx(p["losses"][-1][0],
                                                   rel=2e-2)
        assert np.abs(np.subtract(c["w"], p["w"])).max() < 5e-3
        assert {k: v["bytes"] for k, v in p["trace"].items()} == {
            "pmean[data]": 4 * dim + 4}
        assert {k: v["bytes"] for k, v in c["trace"].items()} == {
            "psum[data]": dim, "pmax[data]": 4, "pmean[data]": 4}
        assert c["trace"]["psum[data]"]["wire"] == dim * 2 * (2 - 1) / 2


def test_k_steps_over_gloo_run_eagerly_and_equal_single_steps(job):
    for r in job:
        ks = r["kstep"]
        assert ks["captured"] is False
        np.testing.assert_array_equal(ks["w_k"], ks["w_single"])
        assert ks["l_k"][0] == [x[0] for x in ks["l_single"]]
