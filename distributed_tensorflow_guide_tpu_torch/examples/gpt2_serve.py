"""End-to-end serving story: corpus -> BPE tokenizer -> sync-DP training
-> the continuous-batching engine -> streamed completions.

The engine-side companion of ``gpt2_generate.py``: the trained model is
served through ``serve/engine.py`` (a fixed-slot decode batch over a
paged KV pool; on a card the decode step and the prefill chunk are CUDA
graphs over K6, its split regime for decode steps and its chunk regime
for bf16 prefill chunks of 10 rows or more). Requests arrive staggered, so
prompts are admitted mid-flight. The first request's stream is checked
against a one-shot ``make_generate_fn`` run, bitwise::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.gpt2_serve --fake-devices 8 --steps 300 \\
        --prompts "the quick brown|pack my box|how vexingly"

``--fake-devices N``: N gloo ranks on the CPU train the model; every rank
then serves the same requests. ``--decode-impl`` as in
``gpt2_generate.py`` (``dense`` raises on a card). One flag more than the
JAX twin: ``--precision``, its companion's, because K6's chunk regime
takes bf16 queries only (an f32 model prefills through the split
regime). On a card the bitwise check holds where the one-shot's prefill
takes the engine's regime: with bf16, a first prompt of 10 to 64 tokens.
"""

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402

from distributed_tensorflow_guide_tpu_torch.core.mesh import (  # noqa: E402
    world_and_rank,
)
from distributed_tensorflow_guide_tpu_torch.examples import (  # noqa: E402
    _common,
)
from distributed_tensorflow_guide_tpu_torch.examples import (  # noqa: E402
    gpt2_generate as G,
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", default=None, metavar="CORPUS")
    ap.add_argument("--bpe-vocab", type=int, default=384)
    ap.add_argument("--prompts",
                    default="the quick brown|pack my box|"
                            "how vexingly|the lazy",
                    help="'|'-separated prompts, submitted with "
                         "staggered arrivals")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--precision", default="auto",
                    choices=["auto", "f32", "bf16", "bf16_remat",
                             "bf16_remat_attn"],
                    help="mixed-precision policy (core/precision.py), the "
                         "flag of gpt2_generate.py; 'auto' keeps this "
                         "demo's f32")
    ap.add_argument("--kv-dtype", choices=["model", "int8"],
                    default="model")
    ap.add_argument("--decode-impl", choices=["auto", "dense", "pallas"],
                    default="auto")
    ap.add_argument("--slots", type=int, default=2,
                    help="decode batch width: fewer slots than prompts "
                         "makes mid-flight admission visible")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=17)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cache full prompt blocks in the radix prefix "
                         "index: repeated prompt prefixes skip their "
                         "prefill (watch prefill_tokens_saved in health)")
    _common.add_device_args(ap)
    return ap


def run(args, *, model=None) -> dict:
    """``model``: a Transformer of ``gpt2_generate.lm_config``'s widths on
    the device holding the starting weights (default ``init_weights(0)``)."""
    from distributed_tensorflow_guide_tpu_torch.models.generation import (
        make_generate_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        Request,
        ServeEngine,
    )

    dev = _common.device_of(args)
    workdir = Path(tempfile.mkdtemp(prefix="gpt2_serve_"))
    before = _common.kernel_counts()
    try:
        tokenizer, loader, _ = G.prepare_corpus(args, workdir)
        cfg = G.lm_config(args, tokenizer.vocab_size)
        model, losses, wall = G.train_lm(args, dev, cfg, loader,
                                         model=model, every=100)
        loader.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    train_launches = _common.launches_since(before)

    # ---- the engine: the trained weights, the serving-side levers -------
    serve_cfg = G.serving_config(cfg, args, dev)
    eng = ServeEngine(serve_cfg, model, slots=args.slots,
                      num_blocks=args.num_blocks,
                      block_size=args.block_size,
                      prefill_chunk=args.prefill_chunk,
                      temperature=args.temperature, top_k=args.top_k,
                      prefix_cache=args.prefix_cache, device=dev)
    prompts = [p.strip() for p in args.prompts.split("|") if p.strip()]
    encoded = {}
    for rid, text in enumerate(prompts):
        toks = np.asarray(tokenizer.encode(text.encode()), np.int32)
        encoded[rid] = toks
        # staggered arrivals: later prompts land while earlier ones decode;
        # with fewer slots than prompts the queue drains into slots as they
        # free, all through the same two step functions
        eng.submit(Request(rid=rid, prompt=toks,
                           max_new_tokens=args.max_new,
                           rng=np.array([0, rid], np.uint32),
                           arrival=0.1 * rid))
    print(f"serving {len(prompts)} prompts on {args.slots} slots",
          flush=True)
    now = 0.0
    n_tokens = 0
    serve_before = _common.kernel_counts()
    clock = _common.Clock(dev)
    while eng.sched.has_queued or eng.sched.has_resident:
        evs, kind = eng.step(now)
        if kind == "idle":
            nxt = eng.sched.next_arrival()
            if nxt is None:
                break
            now = max(now, nxt)
            continue
        now += 0.01  # the demo's clock: one tick a launch
        for e in evs:
            n_tokens += e.status == "ok"
            piece = tokenizer.decode([e.token])
            tag = "first" if e.first else ("done" if e.done else "")
            print(f"  req {e.rid} += {piece!r} {tag}")
    serve_s = clock.stop()
    serve_launches = _common.launches_since(serve_before)
    print("--")
    completions = eng.completions()
    for rid, toks in sorted(completions.items()):
        full = tokenizer.decode(encoded[rid].tolist() + toks)
        print(f"req {rid}: {full!r}")

    # the spot check: the engine's stream is a one-shot run's, bitwise
    gen = make_generate_fn(serve_cfg, max_new_tokens=args.max_new,
                           temperature=args.temperature, top_k=args.top_k,
                           device=dev)
    one = gen(model, encoded[0][None], np.array([0, 0], np.uint32))
    oracle = one[0, len(encoded[0]):].tolist()
    if completions[0] != oracle:
        raise AssertionError("engine/one-shot divergence")
    print("engine == one-shot for req 0: ok")

    # shutdown: the health counters and the block ledger's audit (every
    # pool block accounted for before the engine goes away)
    health = eng.health()
    print(f"health: {health}")
    eng.sched.pool.check_leaks()
    eng.close()
    print("pool.check_leaks(): clean")
    print("serve ok", flush=True)
    return {"done": "serve ok", "device": str(dev),
            "world": world_and_rank()[0], "losses": losses,
            "completions": {str(k): v for k, v in completions.items()},
            "train_s": wall, "serve_s": serve_s,
            "served_tokens_per_s": n_tokens / serve_s,
            "steps": dict(eng.steps),
            "prefill_tokens_saved": health.get("prefill_tokens_saved"),
            "train_launches": train_launches,
            "serve_launches": serve_launches,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
