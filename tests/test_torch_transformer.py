"""The PyTorch port's Transformer, weight bridge, generator and device rule,
held to the JAX package on the same weights.

Geometry is the serve CLI's (vocab 256, 2 layers, 2 heads, d_model 32,
d_ff 64, max_len 64, float32). The JAX side reaches its decode kernels
through Pallas interpret mode (``decode_impl="pallas"``). Logit
tolerance: 2e-5 absolute, 1e-5 relative — float32 throughout, the two
frameworks only sum in other orders.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.models import generation as jgen
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.serve import engine as jeng
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.core.device import (
    resolve_device,
)
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf

JCFG = jtf.TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                             d_model=32, d_ff=64, max_len=64, causal=True,
                             dtype=jnp.float32)
TCFG = ttf.TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                             d_model=32, d_ff=64, max_len=64, causal=True,
                             dtype=torch.float32)
TOL = dict(atol=2e-5, rtol=1e-5)
REPO = Path(__file__).resolve().parents[1]


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


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.int32)


def test_bridge_round_trip_is_bitwise(jparams, model):
    tree = jax.tree.map(np.asarray, fnn.meta.unbox(jparams))
    back = bridge.params_to_flax(model.state_dict(), TCFG)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        other = flat_b[path]
        assert other.shape == leaf.shape and other.dtype == leaf.dtype
        np.testing.assert_array_equal(other, leaf, err_msg=str(path))
    sd = bridge.params_from_flax(back, TCFG)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_training_view_logits_match_jax(jparams, model):
    toks = _tokens(1, 2, 24)
    want = jtf.Transformer(JCFG).apply({"params": jparams}, toks)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_contiguous_decode_view_matches_jax_kernel_path(jparams, model, kv):
    """Prefill a 9-token prompt, then decode three tokens: logits at every
    call, K5 on the port side, the Pallas kernel on the JAX side."""
    jcfg = dataclasses.replace(JCFG, kv_dtype=kv, decode_impl="pallas")
    jm = jtf.Transformer(jgen.decode_config(jcfg))
    jcache = jgen.init_cache(jcfg, jparams, 2)
    dm = model.with_config(tgen.decode_config(
        dataclasses.replace(TCFG, kv_dtype=kv)))
    cache = dm.init_cache(2)
    toks = _tokens(2, 2, 12)
    steps = [(0, toks[:, :9])] + [(9 + i, toks[:, 9 + i:10 + i])
                                 for i in range(3)]
    for idx, chunk in steps:
        want, mut = jm.apply({"params": jparams, "cache": jcache}, chunk,
                             idx, mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = dm(torch.from_numpy(chunk).long(), idx, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"index {idx}")
    # the in-place cache holds what the JAX cache collection holds
    jk = np.asarray(jcache["block_0"]["attn"]["cached_key"])
    np.testing.assert_allclose(cache[0]["k"].float().numpy(),
                               jk.astype(np.float32), atol=1e-5)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_paged_decode_view_matches_jax_kernel_path(jparams, model, kv):
    """Two requests through a shuffled pool: a 6-token chunk each, then
    single tokens at ragged positions (request 1 rewinds and rewrites)."""
    nb, bs = 17, 8
    jcfg = dataclasses.replace(JCFG, kv_dtype=kv, decode_impl="pallas")
    pj = jeng.paged_config(jcfg, num_blocks=nb, block_size=bs)
    jm = jtf.Transformer(pj)
    jpool = jeng.paged_cache_pool(pj, 2)
    tcfg = dataclasses.replace(TCFG, kv_dtype=kv)
    pm = model.with_config(dataclasses.replace(
        tgen.decode_config(tcfg), paged_num_blocks=nb,
        paged_block_size=bs))
    pool = pm.init_pool()
    perm = np.random.RandomState(3).permutation(nb - 1).astype(np.int32)
    tables = perm[:16].reshape(2, 8)
    toks = _tokens(4, 2, 8)
    steps = [(np.array([0, 0], np.int32), toks[:, :6]),
             (np.array([6, 6], np.int32), toks[:, 6:7]),
             (np.array([7, 3], np.int32), toks[:, 7:8])]
    for idx, chunk in steps:
        want, mut = jm.apply({"params": jparams, "cache": jpool}, chunk,
                             jnp.asarray(idx), block_tables=tables,
                             mutable=["cache"])
        jpool = mut["cache"]
        with torch.no_grad():
            got = pm(torch.from_numpy(chunk).long(), torch.from_numpy(idx),
                     cache=pool, block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"index {idx}")
    jv = np.asarray(jpool["block_1"]["attn"]["cached_value"])
    np.testing.assert_allclose(pool[1]["v"].float().numpy(),
                               jv.astype(np.float32), atol=1e-5)


def test_greedy_generate_matches_jax(jparams, model):
    prompt = _tokens(5, 2, 7)
    jgenerate = jgen.make_generate_fn(JCFG, max_new_tokens=12,
                                      temperature=0.0)
    want = np.asarray(jgenerate(jparams, jnp.asarray(prompt),
                                jax.random.PRNGKey(3)))
    generate = tgen.make_generate_fn(TCFG, max_new_tokens=12,
                                     temperature=0.0, device="cpu")
    got = generate(model, prompt, np.asarray(jax.random.PRNGKey(3)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_a_function_of_key_and_position(model):
    """Same key -> same stream; another key -> another stream; every
    token is inside the top-k of its step's logits."""
    prompt = _tokens(6, 1, 5)
    generate = tgen.make_generate_fn(TCFG, max_new_tokens=16,
                                     temperature=0.8, top_k=5, device="cpu")
    a = generate(model, prompt, np.array([0, 7], np.uint32))
    b = generate(model, prompt, np.array([0, 7], np.uint32))
    c = generate(model, prompt, np.array([0, 8], np.uint32))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        logits = model(a)[0, 4:-1]
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert (top5 == a[0, 5:, None]).any(dim=-1).all()


def test_sample_rows_equals_one_row_sample():
    """Row b of the engine's per-row sampler is bitwise a B=1 sample with
    that row's position-derived threefry key (the engine == one-shot
    property)."""
    logits = torch.from_numpy(np.random.RandomState(7).randn(4, 256)
                              .astype(np.float32))
    keys = torch.tensor([[0, 1], [0, 2], [5, 1], [0, 1]])
    pos_keys = tgen.fold_in(keys, torch.tensor([3, 3, 3, 9]))
    rows = tgen.sample_rows(logits, pos_keys, 0.9, 50)
    for b in range(4):
        one = tgen._sample(logits[b:b + 1], pos_keys[b], 0.9, 50)
        assert rows[b] == one[0]
    assert len({tuple(k) for k in pos_keys.tolist()}) == 4


@pytest.mark.parametrize("top_k", [1, 10, 64])
@pytest.mark.parametrize("ties", [False, True], ids=["f32", "bf16_ties"])
def test_top_k_draw_at_the_live_columns_equals_the_full_row_draw(top_k,
                                                                 ties):
    """With top-k, the noise is drawn at the columns that survive the
    mask alone (their flat indices): the token is the full-vocabulary
    Gumbel-max draw's, for the one-key sampler (row b at b * V + v) and
    the per-row one; with logits rounded to bf16, ties at the k-th value
    let more than k columns through, and those draw too."""
    rs = np.random.RandomState(top_k)
    logits = torch.from_numpy(rs.randn(6, 3000).astype(np.float32) * 3)
    if ties:
        logits = logits.bfloat16().float()
    keys = tgen.fold_in(torch.from_numpy(_raw_keys(top_k, 6)
                                         .astype(np.int64)),
                        torch.arange(6))
    for keys_b in (keys, keys[:1].expand(6, 2)):
        t = tgen._tempered(logits, 0.8, top_k)
        assert (t > float("-inf")).sum() >= 6 * top_k
        full = torch.argmax(
            tgen.gumbel(keys_b, (logits.shape[-1],)) + t, dim=-1)
        got = tgen.sample_rows(logits, keys_b, 0.8, top_k)
        torch.testing.assert_close(got, full, rtol=0, atol=0)
    for key in keys:
        t = tgen._tempered(logits, 0.8, top_k)
        full = torch.argmax(tgen.gumbel(key, t.shape) + t, dim=-1)
        got = tgen._sample(logits, key, 0.8, top_k)
        torch.testing.assert_close(got, full, rtol=0, atol=0)


def _raw_keys(seed, n):
    """n raw (2,) uint32 keys made with numpy, full 32-bit range."""
    return np.random.RandomState(seed).randint(
        0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 256), (1, 50304)])
def test_threefry_bits_uniform_and_fold_in_match_jax_bitwise(shape):
    """The port's copy of JAX's threefry path (``jax_threefry_partitionable``
    on, as this JAX runs): random bits, uniform floats (default range and
    the Gumbel's [tiny, 1)) and fold-in keys, bit for bit."""
    assert jax.config.jax_threefry_partitionable
    tiny = float(np.finfo(np.float32).tiny)
    for key in _raw_keys(len(shape) + shape[-1], 3):
        jkey = jnp.asarray(key)
        tkey = torch.from_numpy(key.astype(np.int64))
        want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
        got = tgen.random_bits(tkey, shape).numpy().astype(np.uint32)
        np.testing.assert_array_equal(got, want)
        for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
            want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32,
                                                 lo, hi))
            got = tgen.uniform(tkey, shape, lo, hi).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
        for data in (0, 1, 511, 2**31 + 7, 2**32 - 1):
            want = np.asarray(jax.random.fold_in(jkey, data))
            got = tgen.fold_in(tkey, data).numpy().astype(np.uint32)
            np.testing.assert_array_equal(got, want)


def test_fold_in_of_many_keys_and_positions_matches_jax():
    """The engine's batched fold-in: (B, 2) keys with (B,) positions."""
    keys = _raw_keys(3, 6)
    pos = np.array([0, 1, 5, 63, 1000, 77], np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                                   jnp.asarray(pos)))
    got = tgen.fold_in(torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_threefry_on_host_arrays_equals_the_tensor_path():
    """Keys folded and bits drawn from numpy arrays (what the engine and
    the one-shot generator do on the host) are bitwise the torch path's,
    and stay numpy."""
    keys = _raw_keys(5, 7).astype(np.int64)
    pos = np.array([0, 1, 9, 700, 2**31, 2**32 - 1, 63], np.int64)
    host = tgen.fold_in(keys, pos)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(
        host, tgen.fold_in(torch.from_numpy(keys),
                           torch.from_numpy(pos)).numpy())
    np.testing.assert_array_equal(tgen.fold_in(keys[2], 9), host[2])
    n = np.array([0, 5, 50303, 2**32 + 3, 7 * 50304 + 11, 1, 2], np.int64)
    bits = tgen._bits_at(host, n)
    assert isinstance(bits, np.ndarray)
    np.testing.assert_array_equal(
        bits, tgen._bits_at(torch.from_numpy(host),
                            torch.from_numpy(n)).numpy())


@pytest.mark.parametrize("shape", [(4, 256), (1, 50304)])
def test_gumbel_noise_matches_jax_within_one_ulp_of_each_log(shape):
    """Gumbel noise -log(-log(u)) from the same key: u is bitwise JAX's
    (test above); each of the two float32 logs may round 1 ulp apart
    between the frameworks. So the inner log agrees within 1 ulp, and the
    noise within that ulp carried through the outer log (d log y = dy / y,
    large where y = -log(u) is near 1) plus 1 ulp of each side's outer
    log."""
    tiny = float(np.finfo(np.float32).tiny)
    for key in _raw_keys(11, 3):
        jkey, tkey = jnp.asarray(key), torch.from_numpy(key.astype(np.int64))
        u = tgen.uniform(tkey, shape, tiny, 1.0)
        inner = (-torch.log(u)).numpy()
        np.testing.assert_array_max_ulp(inner,
                                        np.asarray(-jnp.log(u.numpy())),
                                        maxulp=1)
        want = np.asarray(jax.random.gumbel(jkey, shape, jnp.float32))
        got = tgen.gumbel(tkey, shape).numpy()
        bound = np.spacing(inner) / inner + 2 * np.spacing(np.abs(want))
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("top_k", [10, None], ids=["top10", "full"])
def test_sampled_generate_matches_jax(jparams, model, top_k):
    """Sampled one-shot streams (temperature 0.8) are the JAX package's,
    token for token: the same fold_in(rng, position) keys and the same
    categorical draw over logits that agree to ~1e-5."""
    prompt = _tokens(9, 2, 6)
    for seed in (3, 4):
        jgenerate = jgen.make_generate_fn(JCFG, max_new_tokens=16,
                                          temperature=0.8, top_k=top_k)
        want = np.asarray(jgenerate(jparams, jnp.asarray(prompt),
                                    jax.random.PRNGKey(seed)))
        generate = tgen.make_generate_fn(TCFG, max_new_tokens=16,
                                         temperature=0.8, top_k=top_k,
                                         device="cpu")
        got = generate(model, prompt, np.asarray(jax.random.PRNGKey(seed)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_config_validation_and_deferred_knobs():
    # lora_rank is served now: it needs an adapter count, as in the JAX
    # package
    with pytest.raises(ValueError, match="lora_adapters"):
        dataclasses.replace(TCFG, lora_rank=2)
    # moe_experts is served now, with the JAX package's validation
    assert dataclasses.replace(TCFG, moe_experts=4, moe_capacity=2).moe
    with pytest.raises(ValueError, match="moe_experts must be >= 2"):
        dataclasses.replace(TCFG, moe_experts=1)
    with pytest.raises(ValueError, match="moe_capacity requires"):
        dataclasses.replace(TCFG, moe_capacity=2)
    with pytest.raises(ValueError):
        dataclasses.replace(TCFG, kv_dtype="int4")
    with pytest.raises(ValueError):
        dataclasses.replace(TCFG, paged_num_blocks=8)
    with pytest.raises(ValueError):
        dataclasses.replace(TCFG, paged_num_blocks=8, paged_block_size=7)
    cfg = ttf.gpt2_124m()
    assert (cfg.vocab_size, cfg.num_layers, cfg.d_model, cfg.head_dim,
            cfg.max_len, cfg.dtype) == (50304, 12, 768, 64, 1024,
                                        torch.bfloat16)


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        tgen.make_generate_fn(TCFG, max_new_tokens=2)


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with jax, flax
    and the JAX package blocked."""
    pkg = REPO / "distributed_tensorflow_guide_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in pkg.rglob("*.py"))
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'flax', 'distributed_tensorflow_guide_tpu'):",
        "    sys.modules[name] = None",
        "import importlib",
        f"for m in {mods!r}:",
        "    importlib.import_module(m.removesuffix('.__init__'))",
        "import chip_smoke",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax'))",
        "               for k, v in sys.modules.items() if v is not None)",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
