#!/usr/bin/env python3
"""Run the end-to-end phases of one tree's ``chip_smoke.py`` on one card,
and nothing else: phase 4 (the serve engine, greedy and sampled), phase 5
(the one-shot generator) and phase 7 (the training step). Two trees run
back to back on one machine compare on the same card and host:

    python3 chip_e2e_phases.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each tree runs in a process of its own, which imports that tree's
package and ``chip_smoke.py``, builds its kernels into the tree's own
build directory, draws the phases' inputs from ``--seed`` as
``chip_smoke.py`` does (the kernel checks' draws are replayed, not run),
and prints the phases' lines prefixed with its order and tree. Before
the phases, it prints the host time of one K6 wrapper call at the
engine's decode-step shape: the enqueue alone, and with the card's work
(synchronised once after the calls). Phase 7's flash share against
phase 6 is not measured here (phase 6 does not run). A phase's failed
check fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def k6_call_us(DA, torch, calls: int = 500) -> dict:
    """Host microseconds a K6 wrapper call at the engine's decode step
    (B=8, C=1, H=12, hd=64, block size 16, 64-block tables, bf16)."""
    dev = torch.device("cuda", 0)
    B, H, hd, bs, n_blk = 8, 12, 64, 16, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    k, v = (torch.randn(B * n_blk + 1, H, bs, hd, generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    tables = torch.arange(B * n_blk, dtype=torch.int32,
                          device=dev).view(B, n_blk)
    lengths = torch.full((B,), 700, dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, H, hd, generator=gen, device=dev).bfloat16()

    def call():
        return DA.paged_decode_attention(q, k, v, tables, lengths,
                                         block_size=bs)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"enqueue_us": (t1 - t0) / calls * 1e6,
            "with_card_us": (t2 - t0) / calls * 1e6}


def run_tree(tree: Path, seed: int) -> int:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs

    for mod in (cs, cs.DA):
        if tree not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"imported {mod.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        print("chip_e2e_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    cs._build.build_all()
    print("k6 wrapper host: " + json.dumps(k6_call_us(cs.DA, torch)),
          flush=True)
    rng = np.random.RandomState(seed)
    # chip_smoke.py's phase 3 draws these from ``rng`` before phase 4
    B, S, bs = 8, 1024, 16
    rng.permutation(B * S // bs)
    for _ in ("bf16", "int8"):
        for C in (1, 128):
            rng.randint(C, S + 1, size=B)
    cfg = cs.gpt2_124m(dtype=torch.bfloat16)
    model = cs.Transformer(cfg).init_weights(seed).to("cuda")
    cs.check_engine(cfg, model, rng, kind, seed)
    cs.check_one_shot(cfg, model, rng, kind, seed)
    del model
    torch.cuda.empty_cache()
    nan = float("nan")
    cs.check_training(cfg, rng, seed, kind, {n: nan for n in cs.K1_K3})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_tree(args.trees[0].resolve(), args.seed)
    rc = 0
    for i, tree in enumerate(args.trees):
        tree = tree.resolve()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             "--seed", str(args.seed), str(tree)],
            cwd=tree, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(tree)})
        for line in proc.stdout.splitlines():
            print(f"[{i} {tree.name}] {line}", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            print(f"[{i} {tree.name}] rc={proc.returncode}", flush=True)
            rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
