#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # needs one card

1. print the card (name, power limit);
2. build the CUDA kernels from ``ops/csrc`` with ``nvcc`` (sm_90a);
3. hold each kernel against its plain PyTorch version at GPT-2 124M
   widths (K5: B=8, H=12, hd=64, S=1024, C in {1, 128, 512}; K6: block
   size 16, shuffled tables, ragged lengths, C in {1, 128}; bf16 and int8
   caches) and time kernel, plain version, bound and, for K5 at C=1, one
   ``scaled_dot_product_attention`` call as a yardstick;
4. serve 12 requests through ``ServeEngine`` on ``gpt2_124m`` in bf16
   (random weights from ``--seed``), greedy and sampled: every greedy
   token is checked against a teacher-forced training-view forward, the
   pool must be leak-free, and the K6 launch count must equal the steps
   times the layers;
5. run the one-shot generator (K5) at B=4 with a 512-token prompt, with
   the same teacher-forced check.

Exits non-zero on any failure, and when no CUDA card is present. The
last line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from distributed_tensorflow_guide_tpu_torch.models.generation import (
    make_generate_fn,
)
from distributed_tensorflow_guide_tpu_torch.models.transformer import (
    Transformer,
    gpt2_124m,
)
from distributed_tensorflow_guide_tpu_torch.ops import _build
from distributed_tensorflow_guide_tpu_torch.ops import decode_attention as DA
from distributed_tensorflow_guide_tpu_torch.serve.engine import (
    Request,
    ServeEngine,
)

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_S = 989e12  # dense bf16 tensor-core peak (data sheet)
L2_BYTES = 50 * 2**20
# bf16 keeps 8 significant bits: two roundings of f32 results that differ
# in their last bits can land one bf16 step apart (<= 2**-7 relative)
BF16_ATOL = BF16_RTOL = 1e-2
# teacher-forced check: the emitted token's logit may sit this far below
# the best one. bf16 sums run in another order at another batch width, so
# near-ties can flip; a token from a broken path sits ~3 logit std
# (~1.6 at these widths) below the best.
LOGIT_MARGIN = 0.25
K5_REPLACES = "distributed_tensorflow_guide_tpu/ops/decode_attention.py:176"
K6_REPLACES = "distributed_tensorflow_guide_tpu/ops/decode_attention.py:430"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def graph_ms(fn, n: int, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn(i)``: ``n`` calls captured in
    one CUDA graph, replayed back to back, CUDA events around each replay
    (median), so host launch overhead does not enter the time."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def time_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``n`` calls, CUDA
    events around the whole run, after a warm-up."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ---- phase 3: kernels against their plain versions ------------------------


def _cache_copies(make, bytes_each: int):
    """Enough copies of the cache operands that cycling through them
    keeps each launch's cache out of L2 (what a step meets: every layer
    reads its own cache)."""
    n = max(2, math.ceil(2 * L2_BYTES / max(bytes_each, 1)) + 1)
    return [make() for _ in range(n)]


def _visible_pairs(q_pos):
    """(query, key) pairs the mask lets through: query at position p sees
    p + 1 keys."""
    return int(sum(int(p) + 1 for row in q_pos for p in row))


def _record(results, name, case, out, ref, kernel_ms, plain_ms, nbytes,
            flops, library_ms=None):
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=BF16_ATOL,
                        rtol=BF16_RTOL)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOPS_S * 1e3
    row = {"kernel": name, **case, "max_abs_err": err,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "ok": ok}
    print("kernel_case " + json.dumps(row), flush=True)
    results.append(row)
    if not ok:
        fail(f"{name} {case} disagrees with its plain version "
             f"(max_abs_err {err})")


def check_k5(results, gen):
    B, H, hd, S = 8, 12, 64, 1024
    dev = torch.device("cuda", 0)
    for kv in ("bf16", "int8"):
        for C in (1, 128, 512):
            for length in (S, 700):
                index = length - C

                def make():
                    k = torch.randn(B, H, S, hd, generator=gen, device=dev)
                    v = torch.randn(B, H, S, hd, generator=gen, device=dev)
                    if kv == "int8":
                        k8, ks = DA.quantize_kv(k)
                        v8, vs = DA.quantize_kv(v)
                        return (k8, v8, ks[:, :, None].contiguous(),
                                vs[:, :, None].contiguous())
                    return (k.bfloat16(), v.bfloat16(), None, None)

                cache_dtype = torch.int8 if kv == "int8" else torch.bfloat16
                nbytes = DA.decode_kernel_hbm_bytes(
                    b=B, h=H, s=S, d=hd, dtype=cache_dtype, chunk=C,
                    effective_len=length)
                sets = _cache_copies(make, nbytes)
                q = torch.randn(B, C, H, hd, generator=gen,
                                device=dev).bfloat16()

                def kern(i, q=q, sets=sets, index=index):
                    k, v, ks, vs = sets[i % len(sets)]
                    return DA.decode_attention(q, k, v, index, key_scale=ks,
                                               value_scale=vs)

                def plain(i, q=q, sets=sets, index=index):
                    k, v, ks, vs = sets[i % len(sets)]
                    return DA.decode_attention_plain(
                        q, k, v, index, key_scale=ks, value_scale=vs)

                out, ref = kern(0), plain(0)
                torch.cuda.synchronize()
                kernel_ms = graph_ms(kern, 50)
                plain_ms = time_ms(plain, 5, warmup=1)
                library_ms = None
                if C == 1 and kv == "bf16":
                    def lib(i, q=q, sets=sets, length=length):
                        k, v = sets[i % len(sets)][:2]
                        return F.scaled_dot_product_attention(
                            q.transpose(1, 2), k[:, :, :length],
                            v[:, :, :length])
                    lib_out = lib(0).transpose(1, 2)
                    if not torch.allclose(lib_out.float(), ref.float(),
                                          atol=BF16_ATOL, rtol=BF16_RTOL):
                        fail("the library yardstick disagrees with K5")
                    library_ms = graph_ms(lib, 50)
                q_pos = [[index + c for c in range(C)]] * (B * H)
                flops = 4 * hd * _visible_pairs(q_pos)
                _record(results, "decode_attention",
                        {"B": B, "C": C, "S": S, "length": length,
                         "cache": kv},
                        out, ref, kernel_ms, plain_ms, nbytes, flops,
                        library_ms)
                del sets


def check_k6(results, gen, rng):
    B, H, hd, bs, S = 8, 12, 64, 16, 1024
    n_blk = S // bs
    N = B * n_blk + 1  # + the trash block
    dev = torch.device("cuda", 0)
    perm = rng.permutation(B * n_blk).astype(np.int32)
    tables = torch.as_tensor(perm.reshape(B, n_blk), device=dev)
    for kv in ("bf16", "int8"):
        for C in (1, 128):
            lengths_np = rng.randint(C, S + 1, size=B).astype(np.int32)
            lengths_np[0] = S  # one request at the full length
            lengths = torch.as_tensor(lengths_np, device=dev)

            def make():
                k = torch.randn(N, H, bs, hd, generator=gen, device=dev)
                v = torch.randn(N, H, bs, hd, generator=gen, device=dev)
                if kv == "int8":
                    k8, ks = DA.quantize_kv(k)
                    v8, vs = DA.quantize_kv(v)
                    return (k8, v8, ks[:, :, None].contiguous(),
                            vs[:, :, None].contiguous())
                return (k.bfloat16(), v.bfloat16(), None, None)

            cache_dtype = torch.int8 if kv == "int8" else torch.bfloat16
            nbytes = sum(DA.decode_kernel_hbm_bytes(
                b=1, h=H, s=S, d=hd, dtype=cache_dtype, chunk=C,
                effective_len=int(n)) for n in lengths_np)
            pool_bytes = N * H * bs * DA.cache_slot_bytes(hd, cache_dtype)
            sets = _cache_copies(make, pool_bytes)
            q = torch.randn(B, C, H, hd, generator=gen,
                            device=dev).bfloat16()

            def kern(i, q=q, sets=sets, lengths=lengths):
                k, v, ks, vs = sets[i % len(sets)]
                return DA.paged_decode_attention(
                    q, k, v, tables, lengths, key_scale_pool=ks,
                    value_scale_pool=vs, block_size=bs)

            def plain(i, q=q, sets=sets, lengths=lengths):
                k, v, ks, vs = sets[i % len(sets)]
                return DA.paged_decode_attention_plain(
                    q, k, v, tables, lengths, key_scale_pool=ks,
                    value_scale_pool=vs, block_size=bs)

            out, ref = kern(0), plain(0)
            torch.cuda.synchronize()
            kernel_ms = graph_ms(kern, 50)
            plain_ms = time_ms(plain, 5, warmup=1)
            q_pos = [[int(n) - C + c for c in range(C)]
                     for n in lengths_np for _ in range(H)]
            flops = 4 * hd * _visible_pairs(q_pos)
            _record(results, "paged_decode_attention",
                    {"B": B, "C": C, "block_size": bs,
                     "lengths": lengths_np.tolist(), "cache": kv},
                    out, ref, kernel_ms, plain_ms, nbytes, flops)
            del sets


# ---- phases 4-5: the engine and the one-shot generator --------------------


def teacher_forced_gap(model, prompt, tokens, top_k=None) -> float:
    """Largest shortfall of an emitted token's logit below the bar at its
    position, from one training-view forward over prompt + tokens. The bar
    is the best logit (greedy) or the k-th best (top-k sampling)."""
    seq = torch.as_tensor(np.concatenate([prompt, tokens]),
                          device=model.device)[None]
    with torch.inference_mode():
        logits = model(seq)[0]  # (L, V) float32
    P = len(prompt)
    rows = logits[P - 1:P - 1 + len(tokens)]
    got = rows[torch.arange(len(tokens)),
               torch.as_tensor(tokens, device=rows.device)]
    bar = (rows.max(dim=-1).values if top_k is None
           else torch.topk(rows, top_k, dim=-1).values[:, -1])
    return float((bar - got).max())


def run_engine(cfg, model, prompts, *, temperature, top_k, seed):
    eng = ServeEngine(cfg, model, slots=8, block_size=16, num_blocks=513,
                      prefill_chunk=128, temperature=temperature,
                      top_k=top_k)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=64,
                           rng=np.array([seed, rid], np.uint32)))
    ttft, decode_s = {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.sched.has_queued or eng.sched.has_resident:
        events, kind = eng.step(now=time.perf_counter() - t0)
        t = time.perf_counter() - t0
        if kind == "idle":
            fail("engine idle with work queued")
        if kind == "decode":
            decode_s.append(eng.last_tick_s)
        for e in events:
            if e.first:
                ttft[e.rid] = t
    wall = time.perf_counter() - t0
    eng.sched.pool.check_leaks()
    eng.close()
    got = eng.completions()
    if sorted(got) != list(range(len(prompts))) or any(
            len(got[r]) != 64 for r in got):
        fail("engine did not complete every request with 64 tokens")
    return eng, got, {
        "tokens_per_s": sum(len(t) for t in got.values()) / wall,
        "mean_ttft_s": float(np.mean(list(ttft.values()))),
        "decode_step_ms": 1e3 * float(np.mean(decode_s)),
        "decode_steps": eng.steps["decode"],
        "prefill_chunks": eng.steps["prefill"], "wall_s": wall}


def check_engine(cfg, model, rng, kind, seed) -> int:
    """Phase 4: greedy and sampled engine runs. Returns K6's launches."""
    prompts = [rng.randint(0, 50257, rng.randint(32, 701)).astype(np.int32)
               for _ in range(12)]
    DA.reset_launch_counts()
    steps = 0
    for temperature, top_k in ((0.0, None), (0.8, 20)):
        _, got, stats = run_engine(cfg, model, prompts,
                                   temperature=temperature, top_k=top_k,
                                   seed=seed)
        gap = max(teacher_forced_gap(model, prompts[r], got[r], top_k)
                  for r in got)
        mode = "greedy" if top_k is None else "sampled"
        print(f"engine {mode} on {kind}: " + json.dumps(
            {**stats, "max_logit_gap": gap}), flush=True)
        if gap > LOGIT_MARGIN:
            fail(f"engine {mode}: an emitted token sits {gap} below its "
                 f"bar (margin {LOGIT_MARGIN})")
        steps += stats["decode_steps"] + stats["prefill_chunks"]
    launches = DA.LAUNCHES["paged_decode_attention"]
    if launches != steps * cfg.num_layers:
        fail(f"K6 launched {launches} times, expected {steps} steps x "
             f"{cfg.num_layers} layers")
    if DA.LAUNCHES["decode_attention"]:
        fail("the engine launched K5")
    return launches


def check_one_shot(cfg, model, rng, kind, seed) -> int:
    """Phase 5: the one-shot generator at B=4 with a 512-token prompt.
    Returns K5's launches."""
    B, P, new_tokens = 4, 512, 64
    prompt = rng.randint(0, 50257, (B, P)).astype(np.int64)
    generate = make_generate_fn(cfg, max_new_tokens=new_tokens,
                                temperature=0.0)
    DA.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, prompt, np.array([seed, 99], np.uint32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = DA.LAUNCHES["decode_attention"]
    # one prompt chunk, then one call per further token, in every layer
    if launches != new_tokens * cfg.num_layers:
        fail(f"K5 launched {launches} times, expected {new_tokens} x "
             f"{cfg.num_layers}")
    if DA.LAUNCHES["paged_decode_attention"]:
        fail("the one-shot generator launched K6")
    new = out[:, P:].cpu().numpy()
    gap = max(teacher_forced_gap(model, prompt[b], new[b])
              for b in range(B))
    print(f"one-shot on {kind}: " + json.dumps(
        {"B": B, "prompt": P, "new": new_tokens, "wall_s": wall,
         "tokens_per_s": B * new_tokens / wall, "max_logit_gap": gap}),
        flush=True)
    if gap > LOGIT_MARGIN:
        fail(f"one-shot: an emitted token sits {gap} below the best logit "
             f"(margin {LOGIT_MARGIN})")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} | nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    results = []
    check_k5(results, gen)
    check_k6(results, gen, rng)
    cfg = gpt2_124m(dtype=torch.bfloat16)
    model = Transformer(cfg).init_weights(args.seed).to("cuda")
    launches = {"paged_decode_attention": check_engine(cfg, model, rng, kind,
                                                       args.seed),
                "decode_attention": check_one_shot(cfg, model, rng, kind,
                                                   args.seed)}

    def head(name, pick):
        rows = [r for r in results if r["kernel"] == name]
        r = next(r for r in rows if pick(r))
        return {"ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "max_abs_err": max(x["max_abs_err"] for x in rows)}

    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": DA.KERNEL_SOURCE, "replaces": K5_REPLACES,
         "launches": launches["decode_attention"],
         **head("decode_attention",
                lambda r: r["C"] == 1 and r["cache"] == "bf16"
                and r["length"] == r["S"])},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": DA.KERNEL_SOURCE, "replaces": K6_REPLACES,
         "launches": launches["paged_decode_attention"],
         **head("paged_decode_attention",
                lambda r: r["C"] == 1 and r["cache"] == "bf16")},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
