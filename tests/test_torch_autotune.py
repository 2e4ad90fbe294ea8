"""The port's tuning table (``ops/autotune.py``): the table's mechanics,
the CPU's defaults-only contract, the candidates the kernels take, and the
numerics of every candidate against the JAX package.

Mapped from ``tests/test_autotune.py``: round trip with no re-sweep
(``decode_split`` and ``fused_ce``); the CPU neither reads nor writes the
table and refuses to sweep; stale or invalid entries fall back; the
candidates are valid and fit a split CTA's shared memory; the roofline
models (the port's own; how they differ from the JAX package's is stated
in the test); the sweep space is exact (``split_attention_plain`` at each
keys candidate against the JAX decode attention in Pallas interpret mode,
1e-5 on f32 outputs; the fused CE at each chunk candidate, value 1e-5,
gradients 1e-5 absolute / 1e-4 relative, against the JAX
``fused_cross_entropy``); the flash kernels give their compiled tile; a
recorded entry reaches the kernels' plan; the sweep's runners execute
and agree with the plain split. The candidate grids and the bucket size
key equal the JAX package's.

Sweeps run with an injected ``measure`` on a fake card platform key, the
table in a temporary file.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_guide_tpu.ops import autotune as jat
from distributed_tensorflow_guide_tpu.ops import decode_attention as JDA
from distributed_tensorflow_guide_tpu.ops import fused_ce as jce
from distributed_tensorflow_guide_tpu_torch.ops import autotune
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.ops import flash_attention as FA
from distributed_tensorflow_guide_tpu_torch.ops import fused_ce

CARD = "cuda:FAKE-H100-80GB-HBM3:sm90"
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _tables(isolated_autotune_table, tmp_path, monkeypatch):
    """The JAX package's table isolated (its decode call sites read it),
    and the port's: an empty in-memory table over a temporary file."""
    monkeypatch.setenv("DTG_AUTOTUNE_TABLE", str(tmp_path / "table.json"))
    monkeypatch.delenv("DTG_ONLINE_TUNE", raising=False)
    autotune.reset()
    yield
    autotune.reset()


def _table_file() -> Path:
    return Path(os.environ["DTG_AUTOTUNE_TABLE"])


# ---- table mechanics ---------------------------------------------------------


def test_roundtrip_determinism_no_resweep():
    """Same key, same value, one sweep; the persisted table survives a
    simulated restart; the entry is keyed on (h, hd, cache dtype) only."""
    calls = []

    def measure(keys):
        calls.append(keys)
        return 1.0 / keys  # the largest wins

    kw = dict(h=12, d=64, dtype=torch.bfloat16, b=8, s=1024, block_size=16,
              platform=CARD)
    first = autotune.ensure_split_keys_tuned(measure=measure, **kw)
    assert first == 256 and calls == [64, 128, 256]
    assert autotune.ensure_split_keys_tuned(measure=measure, **kw) == first
    autotune.reset()  # a restart
    assert autotune.ensure_split_keys_tuned(
        measure=measure, **{**kw, "b": 1, "s": 64}) == first
    assert len(calls) == 3
    ent = json.loads(_table_file().read_text())
    (key, val), = ent.items()
    assert key == "decode_split|b0|h12|s0|d64|bfloat16|full|" + CARD
    assert val["keys"] == 256
    assert [r["keys"] for r in val["detail"]["swept"]] == [64, 128, 256]
    # another cache dtype or head count misses back to the fixed rule
    assert autotune.split_keys_for(h=12, d=64, dtype=torch.int8,
                                   platform=CARD) == 256
    assert autotune.split_keys_lookup(h=6, d=64, dtype=torch.bfloat16,
                                      platform=CARD) is None

    # the CE chunk: exact-N entry plus an N-generic one
    ce_calls = []

    def ce_measure(chunk):
        ce_calls.append(chunk)
        return abs(chunk - 4096)  # 4096 wins

    ce = dict(d=64, v=50304, dtype=torch.bfloat16, platform=CARD)
    assert autotune.ensure_ce_tuned(n=8184, measure=ce_measure, **ce) == 4096
    assert ce_calls == list(autotune.CE_CHUNK_CANDIDATES)
    autotune.reset()
    assert autotune.ensure_ce_tuned(n=8184, measure=ce_measure, **ce) == 4096
    assert autotune.ce_chunk_for(n=17, **ce) == 4096  # the generic entry
    assert len(ce_calls) == 6
    assert autotune.ce_chunk_for(n=8184, d=64, v=32000,
                                 dtype=torch.bfloat16, platform=CARD) == 8192


def test_cpu_is_defaults_only_no_table_io():
    """On the CPU the table file is neither read nor written, and sweeps
    and records are refused, even with a populated file whose keys name
    the CPU."""
    seeded = {
        autotune._key("decode_split", 0, 2, 0, 16, "float32", False, "cpu"):
            {"keys": 64},
        autotune._key("fused_ce", 0, 0, 50304, 64, "float32", False, "cpu"):
            {"chunk": 1024},
        autotune._key("dp_bucket", 0, 0, 64, 0, "float32", False, "cpu"):
            {"bucket_bytes": 1 << 20},
    }
    _table_file().write_text(json.dumps(seeded))
    cpu = torch.device("cpu")
    assert autotune.split_keys_for(h=2, d=16, dtype=torch.float32,
                                   device=cpu) == 256
    assert autotune.split_keys_for(h=2, d=128, dtype=torch.float32,
                                   device=cpu) == 128
    assert autotune.ce_chunk_for(n=8, d=64, v=50304, dtype=torch.float32,
                                 device=cpu) == 8192
    assert autotune.ce_chunk_for(n=8, d=64, v=300, dtype=torch.float32,
                                 device=cpu) == 300
    assert autotune.bucket_bytes_for(param_bytes=64 << 20, world=2,
                                     dtype=torch.float32,
                                     device=cpu) == 4 << 20
    q = torch.zeros(2, 1, 2, 16)
    assert DA._plan(q, "split", torch.float32, 1024)[:2] == (4, 256)
    for call in (
            lambda: autotune.ensure_split_keys_tuned(
                h=2, d=16, dtype=torch.float32, b=1, s=64, block_size=8,
                measure=lambda k: 0.0, device=cpu),
            lambda: autotune.ensure_ce_tuned(
                n=8, d=64, v=50304, dtype=torch.float32,
                measure=lambda c: 0.0, device=cpu),
            lambda: autotune.ensure_bucket_tuned(
                param_bytes=64 << 20, world=2, dtype=torch.float32,
                measure=lambda b: 0.0, device=cpu),
            lambda: autotune.split_keys_record(
                h=2, d=16, dtype=torch.float32, keys=64, device=cpu),
            lambda: autotune.ce_record(n=8, d=64, v=50304,
                                       dtype=torch.float32, chunk=1024,
                                       device=cpu),
            lambda: autotune.bucket_record(
                param_bytes=64 << 20, world=2, dtype=torch.float32,
                bucket_bytes=1 << 20, device=cpu)):
        with pytest.raises(RuntimeError, match="defaults-only"):
            call()
    assert json.loads(_table_file().read_text()) == seeded  # untouched


@pytest.mark.parametrize("kernel,field,value,key", [
    ("decode_split", "keys", 96, dict(h=2, d=64, dtype=torch.bfloat16)),
    ("decode_split", "keys", 512, dict(h=2, d=64, dtype=torch.bfloat16)),
    ("decode_split", "keys", 100, dict(h=2, d=64, dtype=torch.int8)),
    ("decode_split", "keys", 256, dict(h=2, d=128, dtype=torch.float32)),
    ("decode_split", "keys", "many", dict(h=2, d=64, dtype=torch.float32)),
    ("fused_ce", "chunk", 0, dict(n=8, d=64, v=50304,
                                  dtype=torch.float32)),
    ("fused_ce", "chunk", -1024, dict(n=8, d=64, v=50304,
                                      dtype=torch.float32)),
    ("dp_bucket", "bucket_bytes", 0, dict(param_bytes=64 << 20, world=2,
                                          dtype=torch.float32)),
    ("dp_bucket", "bucket_bytes", -5, dict(param_bytes=64 << 20, world=2,
                                           dtype=torch.float32)),
], ids=["keys96", "keys512", "keys100_int8", "keys256_wide_f32",
        "keys_not_a_number", "chunk0", "chunk_negative", "bucket0",
        "bucket_negative"])
def test_stale_or_invalid_entries_fall_back_to_default(kernel, field, value,
                                                       key):
    """A hand-edited or stale entry never reaches the kernels or layers:
    the resolver gives the default, and a record of it is refused."""
    dt = autotune._dtype_name(key["dtype"])
    if kernel == "decode_split":
        k = autotune._key(kernel, 0, key["h"], 0, key["d"], dt, False, CARD)
        default = DA.split_keys(key["dtype"], key["d"])
        record = autotune.split_keys_record
    elif kernel == "fused_ce":
        k = autotune._key(kernel, 0, 0, key["v"], key["d"], dt, False, CARD)
        default = 8192
        record = autotune.ce_record
    else:
        k = autotune._key(kernel, 0, 0, 64, 0, dt, False, CARD)
        default = 4 << 20
        record = autotune.bucket_record
    autotune._mem[k] = {field: value}
    if kernel == "decode_split":
        got = autotune.split_keys_for(platform=CARD, **key)
    elif kernel == "fused_ce":
        got = autotune.ce_chunk_for(platform=CARD, **key)
    elif kernel == "dp_bucket":
        got = autotune.bucket_bytes_for(platform=CARD, **key)
    assert got == default
    if isinstance(value, int):
        with pytest.raises(ValueError, match="invalid"):
            record(platform=CARD, **{("chunk" if field == "chunk"
                                      else field): value}, **key)
    assert not _table_file().exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [8, 16, 64, 80, 128])
def test_candidates_all_valid_and_within_shared_memory(dtype, hd):
    """Every keys candidate is one the kernels' entry point takes (a
    multiple of the 8 warps, at most 256) whose split CTA fits the shared
    memory the kernel opts in to, for one row and for 8; f32 rows of 128
    lose 256 (the fixed rule halves there)."""
    cands = autotune.split_keys_candidates(hd, dtype)
    assert cands and DA.split_keys(dtype, hd) in cands
    for keys in cands:
        assert keys % DA.SPLIT_WARPS == 0 and keys <= DA.MAX_SPLIT_KEYS
        for rows in (1, DA.SPLIT_ROWS):
            assert DA.split_smem_bytes(keys, hd, dtype.itemsize,
                                       rows) <= DA.SPLIT_SMEM_CAP
    want = [64, 128] if (dtype == torch.float32 and hd == 128) \
        else [64, 128, 256]
    assert cands == want
    assert autotune.split_keys_candidates(hd, dtype, block_size=128) == [
        k for k in want if k % 128 == 0]
    assert not DA.split_keys_fit(96 + 4, hd, dtype)
    assert not DA.split_keys_fit(512, hd, dtype)


def test_split_shared_memory_model_matches_the_cuda_source():
    """``split_smem`` of csrc/decode_attention.cu by hand: bf16 rows of 64
    (128 bytes: 8 chunks, swizzled), 256 keys, 8 rows: the K and V rows,
    q, and each warp's P and (m, l)."""
    assert DA.split_smem_bytes(256, 64, 2, 8) == (
        2 * 256 * 128 + 8 * 64 * 4 + 8 * 8 * 34 * 4)
    # f32 rows of 80 (320 bytes: 20 chunks, not a power of two: one more)
    assert DA._split_pitch(80, 4) == 336
    # f32 rows of 128 at 256 keys overflow the 227 KiB a CTA may take
    assert DA.split_smem_bytes(256, 128, 4, 1) > DA.SPLIT_SMEM_CAP


def test_roofline_models_are_the_ports_own():
    """``kernel_flops`` / ``kernel_hbm_bytes`` delegate to the port's
    models (2 * hd a visible pair a product; each operand read once at the
    head dim as it is). The JAX package's count Pallas blocks over a head
    dim padded to 128 lanes: at hd 64 its non-causal FLOPs are twice the
    port's, and its causal ones count whole live blocks."""
    kw = dict(b=2, h=3, s=256, d=64)
    full = autotune.kernel_flops("flash_fwd", causal=False, **kw)
    assert full == FA.flash_kernel_flops("flash_fwd", causal=False, **kw)
    assert full == 4 * 64 * 2 * 3 * 256 * 256
    assert jat.kernel_flops("flash_fwd", causal=False, blocks=(128, 128),
                            **kw) == 2 * full
    causal = autotune.kernel_flops("flash_fwd", causal=True, **kw)
    assert causal == 4 * 64 * 2 * 3 * (256 * 257 // 2)
    assert jat.kernel_flops("flash_fwd", causal=True, blocks=(128, 128),
                            **kw) == 2 * full * 3 / 4
    assert autotune.kernel_flops("carry_step", causal=True, **kw) == causal
    assert autotune.kernel_flops("flash_dkv", causal=False, **kw) == 2 * full
    b16 = autotune.kernel_hbm_bytes("flash_fwd", dtype=torch.bfloat16,
                                    **kw)
    t, rows = 2 * 256 * 3 * 64 * 2, 2 * 3 * 256 * 4
    assert b16 == 4 * t + rows
    assert jat.kernel_hbm_bytes("flash_fwd", dtype=jnp.bfloat16, **kw) == (
        4 * 2 * 3 * 256 * 128 * 2 + 2 * 3 * 256 * 128 * 4)
    assert autotune.kernel_hbm_bytes(
        "decode_split", b=8, h=12, s=1024, d=64,
        dtype=torch.int8) == DA.decode_kernel_hbm_bytes(
        b=8, h=12, s=1024, d=64, dtype=torch.int8)


# ---- the sweep space is exact -----------------------------------------------


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("keys", [64, 128, 256])
@pytest.mark.parametrize("chunk", [1, 5])
def test_every_keys_candidate_matches_the_jax_decode_attention(keys, quant,
                                                               chunk):
    """``split_attention_plain`` at each keys candidate (the split
    regime's algorithm with that split) against the JAX K5 in interpret
    mode, at indices that end inside, at and past a split edge."""
    b, h, s, hd = 2, 2, 512, 16
    k, v = _rand(1, b, h, s, hd), _rand(2, b, h, s, hd)
    ks = vs = None
    if quant:
        k8, ksc = JDA.quantize_kv(jnp.asarray(k))
        v8, vsc = JDA.quantize_kv(jnp.asarray(v))
        k, v = np.asarray(k8), np.asarray(v8)
        ks, vs = (np.asarray(x)[:, :, None, :] for x in (ksc, vsc))
    q = _rand(3, b, chunk, h, hd)
    dt = torch.int8 if quant else torch.float32
    assert keys in autotune.split_keys_candidates(hd, dt)
    tt = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    jj = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    for index in (0, keys - chunk, keys, 300, s - chunk):
        want = JDA.decode_attention(jj(q), jj(k), jj(v), index,
                                    key_scale=jj(ks), value_scale=jj(vs),
                                    blk_k=128)
        q_pos = torch.full((b, 1), index) + torch.arange(chunk)[None, :]
        got = DA.split_attention_plain(tt(q), tt(k), tt(v), tt(ks), tt(vs),
                                       q_pos, s, keys)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"index {index}")


V_SMALL = 5000


@pytest.mark.parametrize("chunk", autotune.ce_chunk_candidates(V_SMALL))
def test_every_chunk_candidate_matches_the_jax_fused_ce(chunk):
    """The fused CE's value and gradients at each chunk candidate of a
    5000-token vocab against the JAX ``fused_cross_entropy``."""
    rng = np.random.RandomState(chunk)
    x = rng.randn(3, 4, 16).astype(np.float32)
    w = (0.3 * rng.randn(16, V_SMALL)).astype(np.float32)
    t = rng.randint(0, V_SMALL, (3, 4))

    def j_loss(x, w):
        return jce.fused_cross_entropy(x, w, jnp.asarray(t), chunk=chunk)

    jl, (jdx, jdw) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = fused_ce.fused_cross_entropy(tx, tw, torch.from_numpy(t),
                                        chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **GRAD_TOL)


def test_fused_ce_without_a_chunk_takes_the_default_on_the_cpu():
    """``chunk=None`` resolves through the table: the CPU's default,
    8192 clipped to the vocab, the same value as an explicit chunk."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(5, 16).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.randn(16, 9000)).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 9000, (5,)))
    got = fused_ce.fused_cross_entropy(x, w, t)
    assert torch.equal(got, fused_ce.fused_cross_entropy(x, w, t,
                                                         chunk=8192))
    assert not _table_file().exists()


# ---- the flash kernels and the plumbing -------------------------------------


def test_flash_kernels_give_the_compiled_tile():
    """K1-K4 take no tuned value: any key, even a table entry, gives the
    CUDA tile; nothing records one."""
    for kern in autotune.KERNELS:
        autotune._mem[autotune._key(kern, 0, 0, 256, 64, "bfloat16", True,
                                    CARD)] = {"blk_q": 128, "blk_k": 128}
        kw = dict(b=1, h=1, s=256, d=64, dtype=torch.bfloat16,
                  platform=CARD)
        assert autotune.lookup(kern, **kw) == (FA.TILE, FA.TILE)
        assert autotune.blocks_for(kern, **kw) == (64, 64)
        assert autotune.ensure_tuned(kern, **kw) == (64, 64)
        with pytest.raises(ValueError, match="compiled"):
            autotune.record(kern, blocks=(128, 128), **kw)
    with pytest.raises(ValueError, match="unknown kernel"):
        autotune.lookup("flash_bwd", b=1)


def test_recorded_entry_reaches_resolution_and_a_pool_rule():
    autotune.split_keys_record(h=12, d=64, dtype=torch.bfloat16, keys=64,
                               platform=CARD)
    kw = dict(h=12, d=64, dtype=torch.bfloat16, platform=CARD)
    assert autotune.split_keys_for(**kw) == 64
    assert autotune.split_keys_for(block_size=16, **kw) == 64
    # a pool whose block size the keys are not a multiple of: the rule
    assert autotune.split_keys_for(block_size=128, **kw) == 256
    # the CPU still reads nothing
    assert autotune.split_keys_for(h=12, d=64, dtype=torch.bfloat16,
                                   device="cpu") == 256
    with pytest.raises(ValueError, match="invalid"):
        autotune.split_keys_record(h=12, d=64, dtype=torch.bfloat16,
                                   keys=96, platform=CARD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
def test_split_runners_execute_and_agree_with_the_plain_split(dtype):
    """The sweep's runners on CPU tensors (the wrappers' plain versions):
    each candidate's K5 and K6 outputs against ``split_attention_plain``
    with the same keys on the same operands."""
    r = DA.make_split_runners(b=2, h=2, s=512, d=16, dtype=dtype,
                              block_size=16, device="cpu")
    for keys in autotune.split_keys_candidates(16, dtype, 16):
        torch.testing.assert_close(r.k5(keys), r.k5_plain(keys), **TOL)
        torch.testing.assert_close(r.k6(keys), r.k6_plain(keys), **TOL)
    assert autotune.measure_runner(lambda: r.k5(64), iters=3,
                                   device="cpu") > 0.0


# ---- the grids equal the JAX package's --------------------------------------


@pytest.mark.parametrize("v", [1, 1024, 1025, 5000, 50257, 50304, 100000])
def test_ce_chunk_candidates_equal_the_reference(v):
    assert autotune.ce_chunk_candidates(v) == jat.ce_chunk_candidates(v)
    assert autotune.CE_CHUNK_CANDIDATES == jat.CE_CHUNK_CANDIDATES
    assert autotune.DEFAULT_CE_CHUNK == jat.DEFAULT_CE_CHUNK


@pytest.mark.parametrize("param_bytes", [1, 1 << 20, (1 << 20) + 1,
                                         (5 << 20) + 12345, 124_439_808 * 4,
                                         1 << 36])
def test_bucket_candidates_and_size_key_equal_the_reference(param_bytes):
    assert (autotune.bucket_candidates(param_bytes)
            == jat.bucket_candidates(param_bytes))
    assert autotune._param_mib(param_bytes) == jat._param_mib(param_bytes)
    assert autotune.BUCKET_BYTES_CANDIDATES == jat.BUCKET_BYTES_CANDIDATES
    assert autotune.DEFAULT_BUCKET_BYTES == jat.DEFAULT_BUCKET_BYTES
