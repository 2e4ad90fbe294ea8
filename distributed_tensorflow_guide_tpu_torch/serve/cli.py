"""Run the continuous-batching engine on a demo workload.

    python -m distributed_tensorflow_guide_tpu_torch.serve.cli \\
        --requests 6 --slots 2 --prefill-chunk 8

Builds a small randomly initialised model (a scheduling demo, not a
quality demo), submits a staggered mix of prompts, streams every token
event as it is emitted, then prints the per-request completions and the
pool/scheduler counters. Runs on the first CUDA card; ``--device cpu``
runs the same path on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_tensorflow_guide_tpu_torch.serve.cli")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=17)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share a common system prompt across the demo "
                         "requests through the radix prefix cache "
                         "(watch prefill_tokens_saved in health())")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from distributed_tensorflow_guide_tpu_torch.core.device import (
        resolve_device,
    )
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from distributed_tensorflow_guide_tpu_torch.serve.engine import (
        Request,
        ServeEngine,
    )

    device = resolve_device(args.device)
    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                            d_model=32, d_ff=64, max_len=64, causal=True,
                            dtype=torch.float32)
    model = Transformer(cfg).init_weights(args.seed).to(device)
    eng = ServeEngine(cfg, model, slots=args.slots,
                      num_blocks=args.num_blocks,
                      block_size=args.block_size,
                      prefill_chunk=args.prefill_chunk,
                      temperature=args.temperature, top_k=args.top_k,
                      prefix_cache=args.prefix_cache, device=device)
    rng = np.random.RandomState(args.seed)
    sys_prompt = (rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
                  if args.prefix_cache else None)
    for rid in range(args.requests):
        plen = int(rng.choice([4, 8, 16]))
        prompt = rng.randint(0, cfg.vocab_size, plen).astype(np.int32)
        if sys_prompt is not None:
            prompt = np.concatenate([sys_prompt, prompt[:4]])
        eng.submit(Request(
            rid=rid, prompt=prompt, max_new_tokens=args.max_new,
            rng=np.array([0, args.seed * 1000 + rid], np.uint32),
            tenant=rid % 2))
    for ev in eng.run():
        if ev.status != "ok":
            print(f"req {ev.rid:3d} ! {ev.status}")
            continue
        mark = "*" if ev.first else ("." if not ev.done else "$")
        print(f"req {ev.rid:3d} {mark} token {ev.token}")
    print("--")
    for rid, toks in sorted(eng.completions().items()):
        print(f"req {rid}: {toks}")
    print(f"device={device} steps={eng.steps} health={eng.health()}")
    eng.close()
    # shutdown contract: every block accounted for, loudly
    eng.sched.pool.check_leaks()
    print("pool.check_leaks(): clean")


if __name__ == "__main__":
    main()
