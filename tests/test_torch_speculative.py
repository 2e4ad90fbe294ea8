"""The port's speculative decoding and device-index K5, held to the port's
own vanilla generator (bitwise) and to the JAX package's speculative
generator (tokens and acceptance stats, bitwise).

One model: vocab 97, 4 layers (so draft depths 1-3 are proper prefixes),
2 heads, d_model 32, d_ff 64, max_len 32, float32, the JAX weights bridged
into the port. On the CPU the port's K5 wrapper runs its plain version;
the JAX generator runs its own CPU path. Tokens are compared bitwise: the
two frameworks' float32 logits agree to ~1e-6, far inside these seeds'
argmax and Gumbel-max margins, and both sample position p with the key
``fold_in(rng, p)``.
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
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    adapter_bank_shapes,
)

GEOM = dict(vocab_size=97, num_layers=4, num_heads=2, d_model=32, d_ff=64,
            max_len=32, causal=True)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _isolated_table(isolated_autotune_table):
    yield


@pytest.fixture(scope="module")
def jparams():
    return jtf.Transformer(JCFG).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def model(jparams):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    m = ttf.Transformer(TCFG)
    m.load_state_dict(bridge.params_from_flax(tree, TCFG))
    return m.eval()


def _prompt(seed, b=2, p=5):
    return np.random.RandomState(seed).randint(
        0, GEOM["vocab_size"], (b, p)).astype(np.int32)


def _key(i):
    return np.array([0, i], np.uint32)  # == jax.random.PRNGKey(i)


def _gen(cfg=TCFG, **kw):
    return tgen.make_generate_fn(cfg, device="cpu", **kw)


# ---- spec == vanilla inside the port ----------------------------------------


@pytest.mark.parametrize("lookahead", [1, 4])
def test_greedy_spec_equals_port_vanilla_bitwise(model, lookahead):
    prompt = _prompt(14)
    want = _gen(max_new_tokens=8, temperature=0.0)(model, prompt, _key(0))
    gen = _gen(max_new_tokens=8, temperature=0.0, spec_draft_layers=1,
               spec_lookahead=lookahead)
    got = gen(model, prompt, _key(0))
    assert torch.equal(got, want)
    stats = gen.last_stats
    assert stats["verify_steps"] >= 1
    assert 0 <= stats["accepted_drafts"] <= 7


def test_sampled_spec_equals_vanilla_bitwise(model):
    """Temperature 0.7, top-k 12: the draft and the verifier sample a
    position with the same key, so the speculative schedule reproduces
    the sampled vanilla stream too."""
    prompt = _prompt(15, p=4)
    kw = dict(max_new_tokens=12, temperature=0.7, top_k=12)
    want = _gen(**kw)(model, prompt, _key(9))
    for k, g in ((1, 3), (3, 4)):
        got = _gen(spec_draft_layers=k, spec_lookahead=g, **kw)(
            model, prompt, _key(9))
        assert torch.equal(got, want), (k, g)


# ---- port spec == JAX spec ----------------------------------------------------


@pytest.mark.parametrize(
    "draft,lookahead,kv",
    [(k, g, None) for k in (1, 2, 3) for g in (1, 4)] + [(2, 4, "int8")])
def test_spec_matches_jax_on_the_depth_lookahead_grid(jparams, model, draft,
                                                      lookahead, kv):
    """The reference's (draft depth x lookahead) grid, plus its int8-cache
    cell: the port's speculative tokens and its ``last_stats`` (verify
    rounds, accepted drafts) are the JAX generator's."""
    prompt = _prompt(16)
    jcfg = dataclasses.replace(JCFG, kv_dtype=kv)
    tcfg = dataclasses.replace(TCFG, kv_dtype=kv)
    jg = jgen.make_generate_fn(jcfg, max_new_tokens=8, temperature=0.0,
                               spec_draft_layers=draft,
                               spec_lookahead=lookahead)
    want = np.asarray(jg(jparams, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    tg = _gen(tcfg, max_new_tokens=8, temperature=0.0,
              spec_draft_layers=draft, spec_lookahead=lookahead)
    got = tg(model, prompt, _key(0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tg.last_stats == {k: int(v) for k, v in jg.last_stats.items()}


def test_sampled_spec_matches_jax(jparams, model):
    prompt = _prompt(17, p=4)
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=10,
              spec_draft_layers=2, spec_lookahead=3)
    jg = jgen.make_generate_fn(JCFG, **kw)
    want = np.asarray(jg(jparams, jnp.asarray(prompt), jax.random.PRNGKey(5)))
    tg = _gen(**kw)
    np.testing.assert_array_equal(tg(model, prompt, _key(5)).numpy(), want)
    assert tg.last_stats == {k: int(v) for k, v in jg.last_stats.items()}


def test_spec_validation(model):
    """The reference's refusals, with its messages."""
    with pytest.raises(ValueError, match="strictly between"):
        _gen(max_new_tokens=4, temperature=0.0,
             spec_draft_layers=TCFG.num_layers)
    with pytest.raises(ValueError, match="spec_lookahead"):
        _gen(max_new_tokens=4, temperature=0.0, spec_draft_layers=1,
             spec_lookahead=0)
    # the lookahead needs cache headroom past the vanilla budget
    gen = _gen(max_new_tokens=26, temperature=0.0, spec_draft_layers=1,
               spec_lookahead=4)
    with pytest.raises(ValueError, match="max_len"):
        gen(model, np.zeros((1, 4), np.int32), _key(0))
    lora = dataclasses.replace(TCFG, lora_rank=2, lora_adapters=1)
    bank = {name: np.zeros(shape, np.float32)
            for name, (shape, _) in adapter_bank_shapes(lora).items()}
    with pytest.raises(ValueError, match="LoRA is not supported"):
        _gen(lora, max_new_tokens=4, temperature=0.0, spec_draft_layers=1,
             adapters=bank)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_rejected_draft_rows_past_the_index_never_reach_a_token(
        model, monkeypatch, kv):
    """Before every speculative round, every cache row at or past the
    round's index (rows of rejected drafts, rows never written) is filled
    with NaN in both caches (int8: values 127 and NaN scales). K5 reads
    below index + C only, so the stream is still the vanilla one; the
    rounds did reject drafts, so stale rows were there to be read."""
    cfg = dataclasses.replace(TCFG, kv_dtype=kv)
    prompt = _prompt(18)
    kw = dict(max_new_tokens=14, temperature=0.0)
    want = _gen(cfg, **kw)(model, prompt, _key(0))
    poisoned_rounds = []
    clean_round = tgen._Loop._round

    def poisoned(self):
        p = int(self.idx)
        for cache in self.caches:
            for layer in cache:
                for name, t in layer.items():
                    axis = 2 if name in ("k", "v") else 3
                    fill = 127 if t.dtype == torch.int8 else float("nan")
                    t.narrow(axis, p, t.shape[axis] - p).fill_(fill)
        poisoned_rounds.append(p)
        clean_round(self)

    monkeypatch.setattr(tgen._Loop, "_round", poisoned)
    gen = _gen(cfg, spec_draft_layers=1, spec_lookahead=4, **kw)
    got = gen(model, prompt, _key(0))
    assert torch.equal(got, want)
    stats = gen.last_stats
    assert len(poisoned_rounds) == stats["verify_steps"]
    assert stats["accepted_drafts"] < 4 * stats["verify_steps"]  # rejects


# ---- K5's plain version with a device index -----------------------------


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("C", [1, 5])
def test_k5_plain_takes_a_tensor_index_and_ignores_rows_past_it(kind, C):
    """``decode_attention_plain`` (what the CPU runs for K5) with the index
    as a 0-d or (1,) tensor gives the bits of an int index, and NaN or
    1e30 written at or past ``index + C`` leaves every bit alone."""
    rs = np.random.RandomState(C)
    B, H, S, hd = 2, 3, 24, 8
    q = torch.from_numpy(rs.randn(B, C, H, hd).astype(np.float32))
    k = torch.from_numpy(rs.randn(B, H, S, hd).astype(np.float32))
    v = torch.from_numpy(rs.randn(B, H, S, hd).astype(np.float32))
    ks = vs = None
    if kind == "int8":
        k, ks = DA.quantize_kv(k)
        v, vs = DA.quantize_kv(v)
        ks, vs = ks[:, :, None], vs[:, :, None]
    for index in (0, 7, S - C):
        want = DA.decode_attention(q, k, v, index, key_scale=ks,
                                   value_scale=vs)
        for idx in (torch.tensor(index, dtype=torch.int32),
                    torch.tensor([index], dtype=torch.int64)):
            assert torch.equal(DA.decode_attention(
                q, k, v, idx, key_scale=ks, value_scale=vs), want)
        n = index + C
        for garbage in (float("nan"), 1e30):
            dirty = []
            for t, ax in ((k, 2), (v, 2), (ks, 3), (vs, 3)):
                if t is not None:
                    t = t.clone()
                    t.narrow(ax, n, S - n).fill_(
                        127 if t.dtype == torch.int8 else garbage)
                dirty.append(t)
            got = DA.decode_attention(q, dirty[0], dirty[1],
                                      torch.tensor([index]),
                                      key_scale=dirty[2],
                                      value_scale=dirty[3])
            assert torch.equal(got, want), (index, garbage)


@pytest.mark.parametrize("C", [1, 5])
def test_k5_plain_clamps_an_out_of_range_index_as_the_kernel_does(C):
    """A device index out of range is not checked on the host: the kernel
    clamps the live length ``index + C`` to [1, S] and puts the chunk's
    rows at ``length - C + c``; the plain version does the same, so an
    index past the cache gives the bits of ``S - C`` and, at C=1, a
    negative one the bits of 0."""
    rs = np.random.RandomState(40 + C)
    B, H, S, hd = 2, 3, 24, 8
    q, k, v = (torch.from_numpy(rs.randn(*shape).astype(np.float32))
               for shape in ((B, C, H, hd), (B, H, S, hd), (B, H, S, hd)))
    cases = [(S - C + 1, S - C), (S + 40, S - C)]
    if C == 1:
        cases += [(-1, 0), (-40, 0)]
    for wild, same in cases:
        got = DA.decode_attention_plain(q, k, v, torch.tensor([wild]))
        want = DA.decode_attention_plain(q, k, v, same)
        assert torch.equal(got, want), (wild, same)


def test_eager_generator_is_the_generator_on_the_cpu(model):
    """``generate.eager`` (the card's reference for the captured loop)
    runs the same steps; on the CPU nothing is captured."""
    prompt = _prompt(19)
    gen = _gen(max_new_tokens=9, temperature=0.8, top_k=5,
               spec_draft_layers=2, spec_lookahead=2)
    a = gen(model, prompt, _key(2))
    stats = gen.last_stats
    assert torch.equal(gen.eager(model, prompt, _key(2)), a)
    assert gen.last_stats == stats and gen.captures == 0
