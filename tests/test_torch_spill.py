"""The port engine's host KV spill tier and warm cache persistence
(``serve/engine.py``'s ``host_blocks`` / ``persist_cache``, the
``KVMover``) held to the JAX package's ``tests/test_serving.py`` pins on
the CPU (its tests at lines 1104, 1135, 1174, 1201, 1230, 1251, 1279,
1321 and 1376), and greedy streams under pool pressure to the JAX
engine's.

The oracle is the port's one-shot generator (the port engine equals it
bitwise on the CPU, ``tests/test_torch_serving.py``). Geometry: the JAX
tests' (vocab 64, 2 layers, 2 heads, d_model 16, max_len 64, float32),
with the JAX weights bridged into the port. Byte counts are exact: the
port's closed form ``serve/paged_cache.kv_block_bytes`` equals the JAX
package's ``benchmarks/common.spill_bytes_per_swap`` here (block size 8
equals head dim 8; see ROADMAP Queue 3 for the two closed forms at other
shapes).
"""

import dataclasses
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import spill_bytes_per_swap
from distributed_tensorflow_guide_tpu.models import transformer as jtf
from distributed_tensorflow_guide_tpu.serve import Request as JRequest
from distributed_tensorflow_guide_tpu.serve import ServeEngine as JServeEngine
from distributed_tensorflow_guide_tpu_torch import bridge
from distributed_tensorflow_guide_tpu_torch.models import generation as tgen
from distributed_tensorflow_guide_tpu_torch.models import transformer as ttf
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
    pool_leaves,
)
from distributed_tensorflow_guide_tpu_torch.serve.paged_cache import (
    BlockStore,
    kv_block_bytes,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny ops: one intra-op thread a worker keeps them from spinning
    against the other test workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=16,
            d_ff=32, max_len=64, causal=True)
JCFG = jtf.TransformerConfig(**GEOM, dtype=jnp.float32)
TCFG = ttf.TransformerConfig(**GEOM, dtype=torch.float32)
PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
           np.array([2, 4, 6, 8, 10, 12, 14, 16, 18], np.int32),
           np.array([1] * 17, np.int32)]
MAX_NEW = [8, 6, 10]
# two residents needing ~92 positions between them in 8 blocks x 8: one
# is preempted mid-decode
TIGHT_PROMPTS = [np.array([3, 5, 7, 9, 11], np.int32),
                 np.array([2, 4, 6, 8, 10, 12, 14], np.int32)]
TIGHT_MAX_NEW = [40, 40]
ROOMY = dict(slots=2, num_blocks=33, block_size=8, prefill_chunk=8)
TIGHT = dict(slots=2, num_blocks=9, block_size=8, prefill_chunk=8)
HEAD_DIM = GEOM["d_model"] // GEOM["num_heads"]


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


def _key(i):
    return np.array([0, 100 + i], np.uint32)  # == jax.random.PRNGKey(100+i)


def _engine(model, *, cfg=TCFG, temp=0.8, top_k=10, geo=ROOMY, **kw):
    return ServeEngine(cfg, model, temperature=temp, top_k=top_k,
                       device="cpu", **geo, **kw)


def _submit_all(eng, prompts=PROMPTS, max_new=MAX_NEW):
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mn, rng=_key(i)))


_ORACLES: dict = {}


def _oracle(model, i, temp=0.8, top_k=10, *, prompts=PROMPTS,
            max_new=MAX_NEW):
    """Request ``i`` alone through the port's one-shot generator."""
    p, mn = prompts[i], max_new[i]
    key = (i, temp, top_k, tuple(p.tolist()), mn)
    if key not in _ORACLES:
        gen = tgen.make_generate_fn(TCFG, max_new_tokens=mn,
                                    temperature=temp, top_k=top_k,
                                    device="cpu")
        _ORACLES[key] = gen(model, p[None], _key(i))[0, len(p):].tolist()
    return list(_ORACLES[key])


def _ptrs(eng):
    return [leaf.data_ptr() for leaf in pool_leaves(eng.pool)]


# ---- the host tier's ledger -------------------------------------------------


def test_block_store_holder_ledger():
    """The host tier mirrors the pool's refcounted discipline: put = one
    holder, share ref-bumps (a double hold raises), free deletes the
    payload only at refcount 0, a full store returns None with no state
    change, and ids are never recycled."""
    store = BlockStore(capacity=2)
    row = [np.arange(4, dtype=np.float32)]
    h0 = store.put(1, row)
    h1 = store.put(1, [np.zeros((2,), np.int8)])
    assert store.put(1, row) is None
    assert store.live_blocks() == 2
    store.share(2, [h0])
    assert store.refcount(h0) == 2
    with pytest.raises(ValueError, match="already holds"):
        store.share(2, [h0])
    with pytest.raises(ValueError, match="dead host block"):
        store.share(3, [99])
    store.free(1, [h0])
    np.testing.assert_array_equal(store.get(h0)[0], row[0])
    with pytest.raises(ValueError, match="does not own"):
        store.free(3, [h1])
    store.free(2, [h0])
    with pytest.raises(ValueError, match="dead host block"):
        store.get(h0)
    assert store.owned_by(1) == [h1]
    assert store.bytes_stored() == 2
    assert store.stats() == {"live": 1, "shared": 0, "holds": 1,
                             "bytes": 2}
    h2 = store.put(2, row)
    assert h2 is not None and h2 > h1
    store.check_leaks()


# ---- the fused d2h / h2d ----------------------------------------------------


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_kv_mover_round_trip_writes_in_place(model, kv):
    """One gather of several blocks and one scatter of their payloads
    into other blocks: the rows arrive bitwise, every other block is
    untouched, and every pool leaf keeps its storage (the captured
    graphs hold those addresses on the card)."""
    cfg = dataclasses.replace(TCFG, kv_dtype=kv)
    eng = _engine(model, cfg=cfg, host_blocks=8)
    gen = torch.Generator().manual_seed(3)
    for leaf in pool_leaves(eng.pool):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     dtype=torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = [leaf.clone() for leaf in pool_leaves(eng.pool)]
    ptrs = _ptrs(eng)
    payloads = eng.kv.d2h([3, 7, 5])
    assert len(payloads) == 3
    assert sum(a.nbytes for a in payloads[0]) == kv_block_bytes(cfg, 8)
    eng.kv.h2d([10, 11, 12], payloads)
    assert _ptrs(eng) == ptrs
    for leaf, old in zip(pool_leaves(eng.pool), before):
        for src, dst in ((3, 10), (7, 11), (5, 12)):
            assert torch.equal(leaf[dst], old[src])
        keep = [b for b in range(leaf.shape[0]) if b not in (10, 11, 12)]
        assert torch.equal(leaf[keep], old[keep])
    with pytest.raises(ValueError, match="payload leaf"):
        eng.kv.h2d([1], [[a[:1] for a in payloads[0]]])
    eng.close()


# ---- demotion and swap-in ---------------------------------------------------


def test_spill_preemption_resumes_without_reprefill(model):
    """The eviction squeeze with the host tier on: preemption demotes
    the victim's blocks and re-admission swaps them back in instead of
    re-prefilling — the same streams bitwise, fewer prefill steps than
    the destructive run, both tiers leak-free, the pool written in
    place."""
    kw = dict(geo=TIGHT, temp=0.7, top_k=12)
    base = _engine(model, **kw)
    _submit_all(base, TIGHT_PROMPTS, TIGHT_MAX_NEW)
    base.run()
    eng = _engine(model, host_blocks=16, **kw)
    ptrs = _ptrs(eng)
    _submit_all(eng, TIGHT_PROMPTS, TIGHT_MAX_NEW)
    eng.run()
    sd = eng.sched
    assert sd.preemptions >= 1
    assert sd.spill_resumes >= 1
    assert sd.spill_out_blocks > 0 and sd.spill_in_blocks > 0
    assert sd.swapin_tokens_saved > 0
    for i in range(2):
        assert eng.completions()[i] == base.completions()[i] == _oracle(
            model, i, 0.7, 12, prompts=TIGHT_PROMPTS,
            max_new=TIGHT_MAX_NEW), f"req {i}"
    assert eng.steps["prefill"] < base.steps["prefill"]
    assert _ptrs(eng) == ptrs
    sd.check_leaks()
    assert eng.live_blocks() == 0 and eng.store.live_blocks() == 0
    h = eng.health()
    assert h["spill_d2h_bytes"] == h["spill_out_blocks"] * kv_block_bytes(
        TCFG, 8)
    assert h["spill_resumes"] == sd.spill_resumes and h["host_blocks"] == 0


def test_spill_greedy_streams_equal_jax_engine(jparams, model):
    """The same pressure through both engines with a host tier: the same
    greedy streams, the same schedule (steps, preemptions) and the same
    spill traffic, block for block and byte for byte."""
    jeng = JServeEngine(JCFG, jparams, temperature=0.0, top_k=None,
                        host_blocks=16, **TIGHT)
    for i, (p, mn) in enumerate(zip(TIGHT_PROMPTS, TIGHT_MAX_NEW)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=mn,
                             rng=jax.random.PRNGKey(100 + i)))
    jeng.run()
    eng = _engine(model, geo=TIGHT, temp=0.0, top_k=None, host_blocks=16)
    _submit_all(eng, TIGHT_PROMPTS, TIGHT_MAX_NEW)
    eng.run()
    assert eng.completions() == jeng.completions()
    assert eng.steps == jeng.steps
    jh, th = jeng.health(), eng.health()
    for k in ("preemptions", "spill_out_blocks", "spill_in_blocks",
              "spill_d2h_bytes", "spill_h2d_bytes",
              "spill_prefetched_blocks", "spill_resumes",
              "swapin_tokens_saved"):
        assert th[k] == jh[k], k
    assert th["spill_resumes"] >= 1


@pytest.mark.parametrize("victim", ["spilled", "destructive", "mid_replay"])
def test_replay_continuations_stay_bitwise(model, victim, tmp_path):
    """``continuations="replay"`` (the card's form) on the CPU: a victim
    that spills, one preempted destructively, and one preempted while
    still feeding back its replay tokens (the spill refuses it: its
    record could not hold the rest of the replay) each end bitwise the
    uninterrupted port engine."""
    kw = dict(geo=TIGHT, temp=0.7, top_k=12, continuations="replay")
    want = [_oracle(model, i, 0.7, 12, prompts=TIGHT_PROMPTS,
                    max_new=TIGHT_MAX_NEW) for i in range(2)]
    if victim != "mid_replay":
        eng = _engine(model, host_blocks=16 if victim == "spilled" else 0,
                      **kw)
        _submit_all(eng, TIGHT_PROMPTS, TIGHT_MAX_NEW)
        eng.run()
        sd = eng.sched
        assert sd.preemptions >= 1
        assert (sd.spill_resumes >= 1) == (victim == "spilled")
    else:
        # a restored stream re-enters as a replay continuation
        first = _engine(model, host_blocks=16,
                        snapshot_dir=str(tmp_path / "s"), **kw)
        _submit_all(first, TIGHT_PROMPTS, TIGHT_MAX_NEW)
        for _ in range(12):  # both streams decoding
            first.step()
        first.save_snapshot()
        first.close()
        eng = _engine(model, host_blocks=16,
                      snapshot_dir=str(tmp_path / "s"), **kw)
        eng.restore_latest_snapshot()
        sd = eng.sched
        for _ in range(40):  # until rid 1 is feeding back its tokens
            s = next((s for s in sd.slots if s is not None and s.rid == 1),
                     None)
            if s is not None and s.phase == "decode" and s.replay:
                break
            eng.step()
        assert s is not None and s.replay
        spilled = sd.spill_out_blocks
        sd._preempt(sd.slots.index(s))
        assert sd.spill_out_blocks == spilled  # the spill refused it
        assert sd.queue[0].rid == 1 and sd.queue[0].replay
        eng.run()
    assert [eng.completions()[i] for i in range(2)] == want
    eng.close()
    eng.sched.check_leaks()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_spill_roundtrip_parity_across_levers(model, kv):
    """Swap-out / swap-in is bitwise for both pool layouts (f32 rows;
    int8 rows with their f32 scale leaves): cache a prompt, demote its
    trie prefix to the host tier, re-serve the prompt — the claim
    promotes by swap-in and the stream still equals the oracle."""
    cfg = dataclasses.replace(TCFG, kv_dtype=kv)
    eng = _engine(model, cfg=cfg, geo=dict(ROOMY, num_blocks=17),
                  prefix_cache=True, host_blocks=8)
    _submit_all(eng, PROMPTS[:2], MAX_NEW[:2])
    eng.run()
    first = eng.completions()[1]
    sd = eng.sched
    freed = sd.prefix.demote_many(sd.pool, sd._cache_demote_batch)
    assert freed
    before = sd.spill_in_blocks
    eng.submit(Request(rid=9, prompt=PROMPTS[1], max_new_tokens=MAX_NEW[1],
                       rng=_key(1)))
    eng.run()
    assert sd.spill_in_blocks > before
    assert eng.completions()[9] == first
    if kv is None:
        assert first == _oracle(model, 1)
    eng.close()
    sd.check_leaks()


def test_cow_shared_block_spills_once(model):
    """A device block with two holders crosses the tier boundary ONCE:
    the first demotion copies, the second ref-bumps the same host
    payload (one block's bytes for two demotions)."""
    eng = _engine(model, temp=0.0, top_k=None, host_blocks=8)
    sd = eng.sched
    (b,) = sd.pool.alloc(7, 1)
    sd.pool.share(8, [b])
    h7 = sd._demote_block(7, b)
    once = sd.spill_d2h_bytes
    assert once == eng.store.bytes_stored() == kv_block_bytes(TCFG, 8)
    h8 = sd._demote_block(8, b)
    assert h8 == h7
    assert eng.store.refcount(h7) == 2
    assert sd.spill_out_blocks == 2
    assert sd.spill_d2h_bytes == once
    sd.pool.free(7, [b])
    sd.pool.free(8, [b])
    eng.store.free(7, [h7])
    eng.store.free(8, [h8])
    sd.check_leaks()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_spill_byte_model_is_exact(model, kv):
    """One demoted block's host bytes equal the port's closed form and
    the JAX package's, for both layouts: K/V rows at the cache dtype,
    plus the f32 scale rows when quantised (2,048 and 768 bytes here)."""
    cfg = dataclasses.replace(TCFG, kv_dtype=kv)
    eng = _engine(model, cfg=cfg, host_blocks=4,
                  geo=dict(ROOMY, num_blocks=33 if kv is None else 17))
    sd = eng.sched
    (b,) = sd.pool.alloc(5, 1)
    h = sd._demote_block(5, b)
    want = spill_bytes_per_swap(GEOM["num_layers"], GEOM["num_heads"], 8,
                                HEAD_DIM, kv, activation_dtype_bytes=4)
    assert sd.spill_d2h_bytes == eng.store.bytes_stored() == want
    assert want == kv_block_bytes(cfg, 8) == (2048 if kv is None else 768)
    sd.pool.free(5, [b])
    eng.store.free(5, [h])
    sd.check_leaks()


def test_spilled_prefix_claim_promotes_by_swap_in(model):
    """The trie indexes prefixes beyond device residency: demote every
    cached prefix (the trie keeps its structure, no device block held),
    then repeat the longest prompt — the claim swaps its two blocks back
    in, counts them in ``swapin_tokens_saved``, and the stream stays
    bitwise."""
    eng = _engine(model, prefix_cache=True, host_blocks=8)
    _submit_all(eng)
    eng.run()
    sd = eng.sched
    nodes = sd.prefix.size
    freed = sd.prefix.demote_many(sd.pool, sd._cache_demote_batch)
    assert len(freed) == nodes >= 3
    assert sd.prefix.stats()["spilled"] == nodes
    saved0 = sd.prefill_tokens_saved
    eng.submit(Request(rid=9, prompt=PROMPTS[2], max_new_tokens=MAX_NEW[2],
                       rng=_key(2)))
    eng.run()
    assert eng.completions()[9] == _oracle(model, 2)
    assert sd.spill_in_blocks == 2
    assert sd.swapin_tokens_saved == 16
    assert sd.prefill_tokens_saved - saved0 == 16
    eng.close()
    sd.check_leaks()


# ---- warm cache persistence -------------------------------------------------


def _warm_kw(tmp_path):
    return dict(prefix_cache=True, host_blocks=8, persist_cache=True,
                snapshot_dir=str(tmp_path / "snap"))


def test_warm_restart_reprefills_zero_cached_prefix_tokens(model, tmp_path):
    """Kill and warm restore: the snapshot carries the cache CONTENTS, the
    fresh engine's trie comes back entirely in the host tier, and a
    repeat prompt prefills ONLY its uncached suffix chunk."""
    eng = _engine(model, **_warm_kw(tmp_path))
    _submit_all(eng)
    eng.run()
    nodes = eng.sched.prefix.size
    assert nodes >= 3
    assert eng.save_snapshot() is not None
    eng.close()

    eng2 = _engine(model, **_warm_kw(tmp_path))
    assert eng2.restore_latest_snapshot() is not None
    sd = eng2.sched
    assert sd.prefix.size == nodes
    assert sd.prefix.stats()["spilled"] == nodes
    assert sd.pool.live_blocks() == 0
    assert eng2.store.live_blocks() == nodes
    spill_in0, saved0 = sd.spill_in_blocks, sd.prefill_tokens_saved
    pre0 = eng2.steps["prefill"]
    eng2.submit(Request(rid=9, prompt=PROMPTS[2], max_new_tokens=MAX_NEW[2],
                        rng=_key(2)))
    eng2.run()
    assert eng2.completions()[9] == _oracle(model, 2)
    # 17-token prompt, 16 cached: ONE suffix-chunk prefill
    assert eng2.steps["prefill"] - pre0 == 1
    assert sd.prefill_tokens_saved - saved0 == 16
    assert sd.spill_in_blocks - spill_in0 == 2
    eng2.close()
    sd.check_leaks()


def test_corrupt_cache_file_falls_back_to_cold(model, tmp_path):
    """The cache file is best-effort: a truncated payload, a flipped byte
    or a missing CRC sidecar each restore COLD — the snapshot restore
    still succeeds, the repeat prompt re-prefills, and the stream is
    still bitwise."""
    kw = _warm_kw(tmp_path)
    eng = _engine(model, **kw)
    _submit_all(eng)
    eng.run()
    label = eng.save_snapshot()
    path = eng._cache_file(label)
    crc = path[:-4] + ".crc"
    eng.close()
    pristine = {p: open(p, "rb").read() for p in (path, crc)}
    for corruption in ("truncate", "bitflip", "no_crc"):
        for p, raw in pristine.items():
            with open(p, "wb") as f:
                f.write(raw)
        if corruption == "truncate":
            with open(path, "wb") as f:
                f.write(pristine[path][:len(pristine[path]) // 2])
        elif corruption == "bitflip":
            flipped = bytearray(pristine[path])
            flipped[len(flipped) // 2] ^= 0xFF
            with open(path, "wb") as f:
                f.write(bytes(flipped))
        else:
            os.remove(crc)
        eng2 = _engine(model, **kw)
        assert eng2.restore_latest_snapshot() == label
        sd = eng2.sched
        assert sd.prefix.size == 0, corruption
        assert eng2.store.live_blocks() == 0
        pre0 = eng2.steps["prefill"]
        eng2.submit(Request(rid=9, prompt=PROMPTS[2],
                            max_new_tokens=MAX_NEW[2], rng=_key(2)))
        eng2.run()
        assert eng2.completions()[9] == _oracle(model, 2)
        assert eng2.steps["prefill"] - pre0 == 3, corruption
        assert sd.spill_in_blocks == 0
        eng2.close()
        sd.check_leaks()
    shutil.rmtree(str(tmp_path / "snap"))


def test_spill_knob_validation(model):
    with pytest.raises(ValueError, match="host_blocks"):
        _engine(model, host_blocks=-1)
    with pytest.raises(ValueError, match="persist_cache"):
        _engine(model, persist_cache=True)
    with pytest.raises(ValueError, match="continuations"):
        _engine(model, continuations="rewind")


# ---- export / adopt ---------------------------------------------------------


def test_port_engine_adopts_a_record_the_jax_engine_exported(jparams, model):
    """A decode-phase stream exported WITH its KV by the JAX engine (its
    payloads bridged into the port's layout) resumes on a port engine by
    swap-in — no prefill at all — and finishes as the uninterrupted
    stream; the port's own export of the same stream carries the same
    bytes back in the JAX layout."""
    jeng = JServeEngine(JCFG, jparams, temperature=0.8, top_k=10,
                        host_blocks=8, **ROOMY)
    jeng.submit(JRequest(rid=2, prompt=PROMPTS[2], max_new_tokens=MAX_NEW[2],
                         rng=jax.random.PRNGKey(102)))
    for _ in range(6):  # 3 prefill chunks, then decode steps
        jeng.step()
    rec = jeng.export_stream(2, with_kv=True)
    assert rec["payloads"] and rec["written"] > len(PROMPTS[2])
    rec["payloads"] = [bridge.kv_payload_from_flax(p, TCFG)
                       for p in rec["payloads"]]
    eng = _engine(model, host_blocks=8)
    eng.adopt_stream(rec)
    eng.run()
    assert eng.steps["prefill"] == 0 and eng.sched.spill_resumes == 1
    assert eng.completions()[2] == _oracle(model, 2)
    # the port's export, back in the JAX layout
    eng2 = _engine(model, host_blocks=8)
    eng2.submit(Request(rid=2, prompt=PROMPTS[2], max_new_tokens=MAX_NEW[2],
                        rng=_key(2)))
    for _ in range(6):
        eng2.step()
    mine = eng2.export_stream(2, with_kv=True)
    assert mine["written"] == rec["written"]
    assert mine["payload_bytes"] == rec["payload_bytes"]
    for a, b in zip(mine["payloads"], rec["payloads"]):
        # the same rows within float32 rounding of two implementations
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5)
        back = bridge.kv_payload_from_flax(
            bridge.kv_payload_to_flax(a, TCFG), TCFG)
        for x, y in zip(back, a):
            np.testing.assert_array_equal(x, y)
    eng.close()
    eng2.close()
    eng.sched.check_leaks()
