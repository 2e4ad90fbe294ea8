"""The port's decode byte models (``models/generation.py``
``decode_cache_bytes_per_step``, ``paged_decode_cache_bytes_per_step``,
``decode_hbm_bytes_per_step``) held to the JAX package's on one small
config and bridged parameters.

Every case asks for the same float from both packages (``==``: the
models are integer byte counts far below 2**53, so the order of the sums
cannot move them): bf16 and int8 caches; ``effective_len`` of ``None``,
a block-rounded live length and one past ``max_len``; f32, int8 and int4
weight trees (the JAX ``quantize_params`` tree against the port's, int4
packed two to a byte, scales included); and the paged model at
``block_size=8, live_blocks=3, active_slots=2`` (reference
``tests/test_serving.py:329``).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.models import generation as jgen
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.ops import quant as jquant
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.ops import quant as tquant

GEOM = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_len=64, causal=True)
B = 3
# None: the dense step's whole cache; 24: a block-rounded live length;
# max_len + 1: clamped to max_len
LENGTHS = [None, 24, GEOM["max_len"] + 1]
CACHES = {"bf16": None, "int8": "int8"}


def _cfgs(kv):
    """(JAX config, port config) at bf16 compute with the cache ``kv``."""
    return (jtf.TransformerConfig(**GEOM, dtype=jnp.bfloat16, kv_dtype=kv),
            ttf.TransformerConfig(**GEOM, dtype=torch.bfloat16,
                                  kv_dtype=kv))


@pytest.fixture(scope="module")
def trees():
    """{weights: (the JAX param tree, the port's state dict)} for f32,
    int8 and int4 weights, all from one JAX init (f32 masters)."""
    jcfg, tcfg = _cfgs(None)
    params = jtf.Transformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, flax.linen.meta.unbox(params))
    sd = bridge.params_from_flax(params, tcfg)
    out = {"f32": (params, sd)}
    for bits in (8, 4):
        out[f"int{bits}"] = (
            jax.tree.map(np.asarray, jquant.quantize_params(params,
                                                            bits=bits)),
            tquant.quantize_params(sd, bits=bits))
    return out


def _nbytes(tree) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


def test_the_bridged_trees_hold_the_same_bytes(trees):
    """The premise of the parity below: the port's dict stores exactly
    the JAX tree's bytes, in each weight format."""
    for name, (jtree, sd) in trees.items():
        got = sum(t.numel() * t.element_size() for t in sd.values())
        assert got == _nbytes(jtree), name


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("length", LENGTHS)
def test_decode_cache_bytes_equal_the_reference(cache, length):
    jcfg, tcfg = _cfgs(CACHES[cache])
    want = jgen.decode_cache_bytes_per_step(jcfg, B, effective_len=length)
    got = tgen.decode_cache_bytes_per_step(tcfg, B, effective_len=length)
    assert isinstance(got, float) and got == want


@pytest.mark.parametrize("weights", ["f32", "int8", "int4"])
@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("length", LENGTHS)
def test_decode_hbm_bytes_equal_the_reference(trees, weights, cache, length):
    jtree, sd = trees[weights]
    jcfg, tcfg = _cfgs(CACHES[cache])
    want = jgen.decode_hbm_bytes_per_step(jcfg, jtree, B,
                                          effective_len=length)
    got = tgen.decode_hbm_bytes_per_step(tcfg, sd, B, effective_len=length)
    assert isinstance(got, float) and got == want


def test_decode_hbm_bytes_take_a_model_and_charge_gathered_rows(trees):
    """A ``Transformer`` is charged as its state dict; the tables only by
    the rows a step gathers (B token rows and one position row, f32)."""
    _, sd = trees["f32"]
    _, tcfg = _cfgs(None)
    model = ttf.Transformer(tcfg)
    model.load_state_dict(sd)
    assert (tgen.decode_hbm_bytes_per_step(tcfg, model, B)
            == tgen.decode_hbm_bytes_per_step(tcfg, sd, B))
    whole = sum(t.numel() * t.element_size() for t in sd.values())
    tables = sum(sd[k].numel() * 4 for k in ("tok_emb.weight",
                                               "pos_emb.weight"))
    assert tgen.decode_param_bytes_per_step(sd, B) == (
        whole - tables + (B + 1) * GEOM["d_model"] * 4)


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_paged_decode_cache_bytes_equal_the_reference(cache):
    jcfg, tcfg = _cfgs(CACHES[cache])
    kw = dict(block_size=8, live_blocks=3, active_slots=2)
    want = jgen.paged_decode_cache_bytes_per_step(jcfg, **kw)
    got = tgen.paged_decode_cache_bytes_per_step(tcfg, **kw)
    assert isinstance(got, float) and got == want
    # the live blocks, not every slot's max_len
    assert got < tgen.decode_cache_bytes_per_step(tcfg, 2)
    per_slot = GEOM["num_heads"] * (
        2 * tcfg.head_dim * tcfg.cache_dtype.itemsize
        + (8 if cache == "int8" else 0))
    assert got == GEOM["num_layers"] * (3 * 8 + 2) * per_slot


def test_int8_cache_halves_the_bf16_value_bytes():
    """At the serving dtype an int8 cache stores half the value bytes;
    its f32 scale pair a (slot, head) is the only addition."""
    (_, b16), (_, i8) = _cfgs(None), _cfgs("int8")
    slots = GEOM["num_layers"] * B * (GEOM["max_len"] + 1)
    scales = slots * GEOM["num_heads"] * 8
    assert (tgen.decode_cache_bytes_per_step(i8, B)
            == tgen.decode_cache_bytes_per_step(b16, B) / 2 + scales)
    assert dataclasses.replace(b16, kv_dtype="int8").cache_dtype == (
        torch.int8)
