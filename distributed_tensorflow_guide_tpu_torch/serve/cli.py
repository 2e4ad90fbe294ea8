"""Run the continuous-batching engine on a demo workload.

    python -m distributed_tensorflow_guide_tpu_torch.serve.cli \\
        --requests 6 --slots 2 --prefill-chunk 8

Builds a small randomly initialised model (a scheduling demo, not a
quality demo), submits a staggered mix of prompts, streams every token
event as it is emitted, then prints the per-request completions and the
pool/scheduler counters. ``--host-blocks N`` puts a host spill tier of N
blocks under each pool; ``--fleet N [--fleet-roles disagg]`` serves
through an N-replica ``FleetScheduler`` (every replica on the same
device, sharing the model). Runs on the first CUDA card; ``--device
cpu`` runs the same path on the CPU (the kernels' plain versions).
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
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="serve the mix multi-LoRA: requests cycle "
                         "through 3 adapters (0 = base) inside the "
                         "shared decode step")
    ap.add_argument("--host-blocks", type=int, default=0,
                    help="host spill tier of N blocks under each pool: "
                         "preemption and prefix eviction demote to host "
                         "RAM and swap back in (watch spill_* in "
                         "health())")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through an N-replica FleetScheduler "
                         "(global admission/DRR/routing over N stock "
                         "engines) instead of a single engine; watch "
                         "the per-replica healths and fleet counters")
    ap.add_argument("--fleet-roles", choices=["colocated", "disagg"],
                    default="colocated",
                    help="with --fleet: 'disagg' splits prefill/decode "
                         "roles and ships KV blocks at the phase flip")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    import dataclasses

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
        init_adapter_bank,
    )

    device = resolve_device(args.device)
    cfg = TransformerConfig(vocab_size=256, num_layers=2, num_heads=2,
                            d_model=32, d_ff=64, max_len=64, causal=True,
                            dtype=torch.float32)
    bank = None
    if args.lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=args.lora_rank,
                                  lora_adapters=2)
        gen = torch.Generator().manual_seed(args.seed + 7)
        bank = {}
        for name, zeros in init_adapter_bank(cfg).items():
            delta = 0.05 * torch.randn(zeros.shape, generator=gen)
            delta[0] = 0.0  # adapter 0 is the base model
            bank[name] = delta
    model = Transformer(cfg).init_weights(args.seed).to(device)
    kw = dict(slots=args.slots, num_blocks=args.num_blocks,
              block_size=args.block_size, prefill_chunk=args.prefill_chunk,
              temperature=args.temperature, top_k=args.top_k,
              prefix_cache=args.prefix_cache, adapters=bank,
              host_blocks=args.host_blocks, device=device)
    if args.fleet:
        from distributed_tensorflow_guide_tpu_torch.serve.fleet import (
            FleetScheduler,
        )

        eng = FleetScheduler(cfg, model, replicas=args.fleet,
                             roles=args.fleet_roles, **kw)
    else:
        eng = ServeEngine(cfg, model, **kw)
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
            adapter=rid % 3 if args.lora_rank else 0, tenant=rid % 2))
    for ev in eng.run():
        if ev.status != "ok":
            print(f"req {ev.rid:3d} ! {ev.status}")
            continue
        mark = "*" if ev.first else ("." if not ev.done else "$")
        print(f"req {ev.rid:3d} {mark} token {ev.token}")
    print("--")
    for rid, toks in sorted(eng.completions().items()):
        print(f"req {rid}: {toks}")
    if args.fleet:
        print(f"device={device} health={eng.health()}")
    else:
        print(f"device={device} steps={eng.steps} health={eng.health()}")
    eng.close()
    # shutdown contract: every block of every pool and host store
    # accounted for, loudly
    (eng.check_leaks if args.fleet else eng.sched.check_leaks)()
    print("pool.check_leaks(): clean")


if __name__ == "__main__":
    main()
