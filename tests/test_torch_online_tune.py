"""Online in-situ tuning of the port (``ops/autotune.py``'s
``ensure_tuned_online``) and the call sites that route through it.

The JAX package's bounds, each pinned here as ``tests/test_online_tune.py``
pins them there:

* **default off**: with ``DTG_ONLINE_TUNE`` unset nothing sweeps, even on
  a card's platform key with a measure injected;
* **CPU-hermetic**: with the variable set, operands on the CPU take the
  defaults exactly — no sweep, no table file, no attempt — through the
  front door and through the real call sites (the engine's and the
  one-shot's decode split, the fused-CE chunk, the bucket budget);
* **bounded and once**: a first-touch key sweeps once and persists (a
  simulated restart serves it as a lookup hit), a zero budget blocks
  every sweep, and a key whose sweep fails is attempted once and never
  again, its failures counted in ``online_tune_stats()["failed"]``.

The port's own: K5 and K6 resolve one ``decode_split`` entry whatever
the batch, the capacity or the pool; nothing sweeps while the current
stream is reported to capture a graph; ``ServeEngine(online_tune=)`` and
``TrainLoop(online_tune=)`` set the override; in a 2-rank gloo job whose
ranks' measures prefer different values, both ranks end on the first
rank's, and only it writes the table.

Sweeps run with an injected ``measure`` on a fake card platform key
(:data:`CARD`), the table in a temporary file. This file imports neither
jax nor the JAX package: the 2-rank job's ranks import it.
"""

import json
import os
from pathlib import Path

import pytest
import torch

from distributed_tensorflow_guide_tpu_torch.ops import autotune
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.ops import fused_ce

CARD = "cuda:FAKE-H100-80GB-HBM3:sm90"  # a card's platform key, for tests
SPLIT = dict(h=12, d=64, dtype=torch.bfloat16)
SHAPE = dict(b=8, s=1024, block_size=16)


@pytest.fixture(autouse=True)
def _table(tmp_path, monkeypatch):
    monkeypatch.setenv("DTG_AUTOTUNE_TABLE", str(tmp_path / "table.json"))
    monkeypatch.delenv("DTG_ONLINE_TUNE", raising=False)
    monkeypatch.delenv("DTG_ONLINE_TUNE_BUDGET_S", raising=False)
    autotune.reset()
    yield
    autotune.reset()


def _table_file() -> Path:
    return Path(os.environ["DTG_AUTOTUNE_TABLE"])


def _spy():
    calls = []

    def measure(value):
        calls.append(value)
        return 1.0 / value  # the largest candidate wins

    return calls, measure


def _split_online(measure=None, **kw):
    return autotune.ensure_tuned_online(
        autotune.DECODE_SPLIT_KERNEL, measure=measure, platform=CARD,
        shape=SHAPE, **SPLIT, **kw)


# ---- the JAX package's bounds -----------------------------------------------


def test_default_off_no_sweep_even_on_card_keys():
    calls, measure = _spy()
    assert _split_online(measure) == DA.split_keys(torch.bfloat16, 64)
    ce = autotune.ensure_tuned_online(
        autotune.CE_KERNEL, measure=measure, platform=CARD, n=128, d=64,
        v=50304, dtype=torch.bfloat16)
    assert ce == autotune.DEFAULT_CE_CHUNK
    assert calls == []
    assert autotune.online_tune_stats()["attempted"] == 0
    assert not _table_file().exists()


def test_cpu_hermetic_with_env_set(monkeypatch):
    """Exporting DTG_ONLINE_TUNE changes nothing on the CPU: no sweep, no
    table I/O, every resolver its default, even with a populated table
    file whose keys name the CPU."""
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    assert autotune.online_tune_enabled()
    seeded = {autotune._key("decode_split", 0, 12, 0, 64, "bfloat16", False,
                            "cpu"): {"keys": 64},
              autotune._key("fused_ce", 0, 0, 256, 64, "float32", False,
                            "cpu"): {"chunk": 16}}
    _table_file().write_text(json.dumps(seeded))
    calls, measure = _spy()
    cpu = torch.device("cpu")
    assert autotune.ensure_tuned_online(
        autotune.DECODE_SPLIT_KERNEL, measure=measure, device=cpu,
        shape=SHAPE, **SPLIT) == 256
    assert autotune.ensure_tuned_online(
        autotune.CE_KERNEL, measure=measure, device=cpu, n=128, d=64,
        v=256, dtype=torch.float32) == 256  # 8192 clipped to the vocab
    assert autotune.ensure_tuned_online(
        autotune.BUCKET_KERNEL, measure=measure, device=cpu,
        param_bytes=64 << 20, world=2, dtype=torch.float32) == 4 << 20
    # the real call sites
    assert DA.resolve_split_keys(h=12, hd=64, kv_dtype=torch.bfloat16,
                                 q_dtype=torch.bfloat16, device=cpu, b=8,
                                 s=1024, block_size=16) == 256
    assert DA.resolve_split_keys(h=2, hd=128, kv_dtype=torch.float32,
                                 q_dtype=torch.float32, device=cpu, b=1,
                                 s=64) == 128
    assert fused_ce.resolve_chunk(n=128, d=64, v=50304,
                                  dtype=torch.float32, device=cpu) == 8192
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        single_device_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel import overlap

    params = {"w": torch.zeros(1 << 20, requires_grad=True)}
    assert overlap.resolve_bucket_bytes(params, "data",
                                        mesh=single_device_mesh(),
                                        measure=measure) == 4 << 20
    assert calls == []
    assert json.loads(_table_file().read_text()) == seeded  # untouched
    assert autotune.online_tune_stats()["attempted"] == 0


def test_online_sweep_once_persists_then_lookup_hits(monkeypatch):
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    calls, measure = _spy()
    first = _split_online(measure)
    assert first == 256
    assert calls == autotune.split_keys_candidates(64, torch.bfloat16, 16)
    assert _table_file().exists()
    assert _split_online(measure) == first and len(calls) == 3
    stats = autotune.online_tune_stats()
    assert stats["attempted"] == 1 and stats["failed"] == 0
    assert 0 <= stats["spent_s"] <= stats["budget_s"]
    autotune.reset()  # a restart: the file serves the key as a hit
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    assert _split_online(measure) == first and len(calls) == 3
    assert autotune.online_tune_stats()["attempted"] == 0


def test_zero_budget_blocks_all_sweeps(monkeypatch):
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    monkeypatch.setenv("DTG_ONLINE_TUNE_BUDGET_S", "0")
    calls, measure = _spy()
    assert _split_online(measure) == 256
    ce = autotune.ensure_tuned_online(
        autotune.CE_KERNEL, measure=measure, platform=CARD, n=64, d=16,
        v=5000, dtype=torch.float32)
    assert ce == 5000
    assert calls == [] and not _table_file().exists()


def test_failed_sweep_is_attempted_once_and_counted(monkeypatch):
    """Every candidate fails: the default, each failure counted with its
    key and the first 200 characters of its error, and the next
    resolution calls no measure at all."""
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    calls = []

    def measure(keys):
        calls.append(keys)
        raise RuntimeError("launch failed " + "x" * 500)

    assert _split_online(measure) == 256
    assert len(calls) == 3
    assert _split_online(measure) == 256 and len(calls) == 3
    stats = autotune.online_tune_stats()
    assert stats["attempted"] == 1 and stats["failed"] == 3
    fail = stats["failures"][0]
    assert fail["kernel"] == "decode_split" and fail["candidate"] == 64
    assert fail["key"] == {"h": 12, "d": 64, "dtype": "bfloat16"}
    assert len(fail["error"]) == 200
    assert fail["error"].startswith("launch failed")
    assert not _table_file().exists()


def test_a_sweep_that_raises_is_counted_too(monkeypatch):
    """A decode_split sweep without the caller's shape cannot run: it is
    counted as one failure, and the default stands."""
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    got = autotune.ensure_tuned_online(autotune.DECODE_SPLIT_KERNEL,
                                       platform=CARD, **SPLIT)
    assert got == 256
    stats = autotune.online_tune_stats()
    assert stats["attempted"] == 1 and stats["failed"] == 1
    assert "shape" in stats["failures"][0]["error"]


def test_bucket_kernel_needs_measure_even_when_enabled(monkeypatch):
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    key = dict(param_bytes=64 << 20, world=8, dtype=torch.float32)
    out = autotune.ensure_tuned_online(autotune.BUCKET_KERNEL,
                                       platform=CARD, **key)
    assert out == autotune.bucket_bytes_for(platform=CARD, **key)
    assert autotune.online_tune_stats()["attempted"] == 0
    calls, measure = _spy()
    assert autotune.ensure_tuned_online(
        autotune.BUCKET_KERNEL, platform=CARD, measure=measure,
        **key) == 32 << 20
    assert calls == autotune.bucket_candidates(64 << 20)


def test_set_online_tune_override_wins_over_env(monkeypatch):
    assert not autotune.online_tune_enabled()
    prev = autotune.set_online_tune(True)
    assert prev is None and autotune.online_tune_enabled()
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    autotune.set_online_tune(False)
    assert not autotune.online_tune_enabled()  # the override beats the env
    autotune.set_online_tune(None)
    assert autotune.online_tune_enabled()  # cleared: the env gate again


def test_flash_kernels_never_sweep_online(monkeypatch):
    """K1-K4's tile is compiled: the front door gives it with online
    tuning on and a measure injected, and attempts nothing."""
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    calls, measure = _spy()
    for kernel in autotune.KERNELS:
        got = autotune.ensure_tuned_online(
            kernel, measure=measure, platform=CARD, b=1, h=1, s=256, d=64,
            dtype=torch.bfloat16, causal=True)
        assert got == autotune.default_blocks() == (64, 64)
    assert calls == [] and autotune.online_tune_stats()["attempted"] == 0


# ---- the port's own ---------------------------------------------------------


def _as_card(monkeypatch):
    """Every device resolves to the fake card's key; the operands stay on
    the CPU."""
    real = autotune._platform
    monkeypatch.setattr(autotune, "_platform",
                        lambda platform=None, device=None:
                        real(platform or CARD, device))


@pytest.mark.parametrize("keys", [64, 128])
def test_k5_and_k6_resolve_one_entry_whatever_batch_capacity_or_pool(
        monkeypatch, keys):
    """One recorded ``decode_split`` entry serves K5 and K6 at every batch,
    capacity and pool: the resolver, the one-shot's and the engine's
    model views, and the kernels' own plan."""
    from distributed_tensorflow_guide_tpu_torch.models.generation import (
        decode_split_config,
    )
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        TransformerConfig,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        build_step_fns,
    )

    _as_card(monkeypatch)
    autotune.split_keys_record(h=2, d=16, dtype=torch.float32, keys=keys)
    for b, s, bs, n_blk in ((1, 64, 8, None), (8, 1024, 16, 64),
                            (3, 640, 32, 40), (16, 4096, 16, 300)):
        assert DA.resolve_split_keys(
            h=2, hd=16, kv_dtype=torch.float32, q_dtype=torch.float32,
            device="cpu", b=b, s=s, block_size=bs, n_blk=n_blk) == keys
        assert DA.resolve_split_keys(
            h=2, hd=16, kv_dtype=torch.float32, q_dtype=torch.float32,
            device="cpu", b=b, s=s) == keys
        q = torch.zeros(b, 1, 2, 16)
        assert DA._plan(q, "split", torch.float32, s)[1] == keys
        assert DA._plan(q, "split", torch.float32, s, None, bs)[1] == keys
    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                            d_model=32, d_ff=64, max_len=64,
                            dtype=torch.float32)
    for batch in (1, 4):
        assert decode_split_config(cfg, "cpu", batch=batch
                                   ).decode_split_keys == keys
    for slots, nb, bs in ((2, 17, 8), (8, 9, 16)):
        fns = build_step_fns(cfg, slots=slots, num_blocks=nb, block_size=bs,
                             prefill_chunk=8, device="cpu")
        assert fns.cfg.decode_split_keys == keys
    # another head count, dtype or head dim is another key: the default
    assert DA.resolve_split_keys(h=4, hd=16, kv_dtype=torch.float32,
                                 q_dtype=torch.float32, device="cpu", b=1,
                                 s=64) == 256
    assert autotune.online_tune_stats()["attempted"] == 0


def test_explicit_split_keys_the_kernels_refuse_raise():
    q = torch.zeros(1, 1, 2, 128)
    assert DA._plan(q, "split", torch.float32, 512, 128)[:2] == (4, 128)
    for bad in (96 + 4, 512, 0):
        with pytest.raises(ValueError, match="split_keys"):
            DA._plan(q, "split", torch.bfloat16, 512, bad)
    with pytest.raises(ValueError, match="split_keys"):
        DA._plan(q, "split", torch.float32, 512, 256)  # wide f32 rows


def test_no_sweep_while_capture_is_reported(monkeypatch):
    monkeypatch.setenv("DTG_ONLINE_TUNE", "1")
    calls, measure = _spy()
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    assert _split_online(measure) == 256
    ce = autotune.ensure_tuned_online(
        autotune.CE_KERNEL, measure=measure, platform=CARD, n=64, d=16,
        v=5000, dtype=torch.float32)
    assert ce == 5000
    assert calls == [] and autotune.online_tune_stats()["attempted"] == 0
    # out of the capture the key was never attempted: it sweeps now
    monkeypatch.setattr(autotune, "_capturing", lambda: False)
    assert _split_online(measure) == 256 and len(calls) == 3
    autotune.split_keys_record(h=12, d=64, dtype=torch.bfloat16, keys=64,
                               platform=CARD)
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    assert _split_online(measure) == 64  # inside a capture: the lookup


def test_engine_and_train_loop_knobs_set_the_override():
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        ServeEngine,
    )
    from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop

    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                            d_model=32, d_ff=64, max_len=32,
                            dtype=torch.float32)
    model = Transformer(cfg).init_weights(0)
    kw = dict(slots=2, num_blocks=9, block_size=8, prefill_chunk=8,
              device="cpu")
    ServeEngine(cfg, model, online_tune=True, **kw).close()
    assert autotune.online_tune_enabled()
    eng = ServeEngine(cfg, model, **kw)  # None: leaves the override
    assert autotune.online_tune_enabled()
    assert eng.fns.cfg.decode_split_keys == 256  # the CPU's default
    eng.close()
    TrainLoop(lambda s, b: (s, {}), None, [], online_tune=False,
              device="cpu")
    assert not autotune.online_tune_enabled()
    TrainLoop(lambda s, b: (s, {}), None, [], online_tune=True,
              device="cpu")
    assert autotune.online_tune_enabled()
    autotune.set_online_tune(None)


# ---- ranks that must agree ---------------------------------------------------


def agreement_job(table_dir: str) -> dict:
    """One rank of a 2-rank gloo job: each rank's table in a file of its
    own, the fake card's key, online tuning on, and measures that prefer
    the smallest candidate on rank 0 and the largest on rank 1. The
    bucket budget over the data axis (through ``overlap``), then a
    vocab-parallel CE chunk over the world, each resolved twice."""
    import torch.distributed as dist

    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel import overlap

    rank = dist.get_rank()
    table = Path(table_dir) / f"rank{rank}.json"
    os.environ["DTG_AUTOTUNE_TABLE"] = str(table)
    autotune.reset()
    autotune._platform = lambda platform=None, device=None: CARD
    autotune.set_online_tune(True)
    seen = {"bucket": [], "ce": []}

    def prefer(kind):
        def measure(value):
            seen[kind].append(value)
            return value if rank == 0 else 1.0 / value

        return measure

    mesh = build_mesh(MeshSpec(data=2))
    params = {"w": torch.zeros(16 << 20 >> 2, requires_grad=True)}
    buckets = [overlap.resolve_bucket_bytes(params, "data", mesh=mesh,
                                            measure=prefer("bucket"))
               for _ in range(2)]
    chunks = [autotune.ensure_tuned_online(
        autotune.CE_KERNEL, measure=prefer("ce"), group=dist.group.WORLD,
        n=64, d=16, v=50304, dtype=torch.bfloat16) for _ in range(2)]
    stats = autotune.online_tune_stats()
    return {"rank": rank, "buckets": buckets, "chunks": chunks,
            "swept": {k: list(v) for k, v in seen.items()},
            "table_written": table.exists(),
            "attempted": stats["attempted"], "failed": stats["failed"]}


def test_two_ranks_take_the_first_ranks_choice_and_only_it_writes(tmp_path):
    from distributed_tensorflow_guide_tpu_torch.runtime import (
        multiprocess as mp,
    )

    ranks = sorted((r.result for r in mp.run_multiprocess(
        "tests.test_torch_online_tune:agreement_job", 2,
        args=(str(tmp_path),), timeout=240)), key=lambda r: r["rank"])
    first, second = ranks
    bucket_cands = autotune.bucket_candidates(16 << 20)
    ce_cands = autotune.ce_chunk_candidates(50304)
    for r in ranks:
        # rank 0's measure prefers the smallest candidate: every rank
        # takes it, though rank 1's own measure preferred the largest
        assert r["buckets"] == [bucket_cands[0]] * 2
        assert r["chunks"] == [ce_cands[0]] * 2
        # every rank ran the same sweep once (a measure may run
        # collectives), the second resolution none
        assert r["swept"] == {"bucket": bucket_cands, "ce": ce_cands}
        assert r["attempted"] == 2 and r["failed"] == 0
    assert first["table_written"] and not second["table_written"]
    table = json.loads((tmp_path / "rank0.json").read_text())
    assert {e.get("bucket_bytes") for e in table.values()} >= {
        bucket_cands[0]}
