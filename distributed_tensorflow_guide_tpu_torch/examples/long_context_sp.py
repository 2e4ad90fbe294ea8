"""Sequence / context parallelism: ring attention and Ulysses over the
``context`` mesh axis (``parallel/sequence.py``), the long-context
capability the reference never had.

Each rank holds S/n of the sequence. Ring attention passes KV shards
around the ring with an online-softmax carry (on a card, each live visit
is the K4 kernel); Ulysses reshards sequence <-> heads with one
``all_to_all`` each way (K1 on a card). Both are held here to
full-sequence dense attention on one device::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.long_context_sp --fake-devices 8 --context 8
    python -m $E.long_context_sp --fake-devices 8 --impl ulysses
    D=distributed_tensorflow_guide_tpu_torch
    python -m $D.launch -n 4 --device cuda $D/examples/long_context_sp.py \\
        --seq-len 4096

``--fake-devices N``: N gloo ranks on the CPU, where the ring runs its
plain blockwise version. Inputs are f32, the error bound the JAX
example's 2e-4 on every rank.
"""

import argparse
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_tensorflow_guide_tpu_torch.examples import (  # noqa: E402
    _common,
)

MAX_ERR = 2e-4


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", type=int, default=2048, help="global tokens")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--context", type=int, default=-1,
                    help="context-axis size (-1: all ranks)")
    ap.add_argument("--impl", choices=["ring", "ulysses", "both"],
                    default="both")
    ap.add_argument("--causal", action=argparse.BooleanOptionalAction,
                    default=True, help="--no-causal for bidirectional")
    _common.add_device_args(ap)
    return ap


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.collectives import (
        collectives as cc,
    )
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        axis_sizes,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.ops.attention import (
        dense_attention,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.sequence import (
        ring_attention,
        ulysses_attention,
    )

    dev = _common.device_of(args)
    mesh = build_mesh(MeshSpec(data=1, context=args.context))
    ax = mesh.axis("context")
    n_ctx = axis_sizes(mesh)["context"]
    if args.seq_len % n_ctx:
        raise SystemExit(f"context-axis size {n_ctx} must divide "
                         f"--seq-len {args.seq_len}")
    r = np.random.RandomState(0)
    shape = (args.batch, args.seq_len, args.heads, args.head_dim)
    q, k, v = (torch.as_tensor(r.randn(*shape).astype(np.float32),
                               device=dev) for _ in range(3))
    # the single-device oracle: full-sequence dense attention
    oracle = dense_attention(q, k, v, causal=args.causal)
    per = args.seq_len // n_ctx
    mine = slice(ax.index * per, (ax.index + 1) * per)
    qs, ks, vs = (x[:, mine].contiguous() for x in (q, k, v))
    want = oracle[:, mine]
    del q, k, v, oracle

    results = {}
    before = _common.kernel_counts()

    def check(name, fn):
        out = fn(qs, ks, vs, causal=args.causal, mesh=mesh)
        err = cc.pmax(torch.max(torch.abs(out - want)), "context",
                      mesh=mesh).item()
        passes = 3
        _common.sync(dev)
        t0 = time.perf_counter()
        for _ in range(passes):
            out = fn(qs, ks, vs, causal=args.causal, mesh=mesh)
        _common.sync(dev)
        dt = (time.perf_counter() - t0) / passes
        print(f"{name}: {args.seq_len} tokens over {n_ctx}-way context "
              f"axis, max|err vs dense|={err:.2e}, {dt * 1e3:.1f} ms/pass "
              f"(per-device KV memory 1/{n_ctx} of dense)", flush=True)
        if not err < MAX_ERR:
            raise AssertionError(f"{name} diverged from the dense oracle")
        results[name] = {"max_err": err, "ms_per_pass": dt * 1e3}

    if args.impl in ("ring", "both"):
        check("ring attention", ring_attention)
    if args.impl in ("ulysses", "both"):
        if args.heads % n_ctx == 0:
            check("ulysses", ulysses_attention)
        else:
            print(f"ulysses skipped: heads {args.heads} % context {n_ctx} "
                  "!= 0", flush=True)
    done = "long-context SP ok"
    print(done, flush=True)
    return {"done": done, "device": str(dev), "world": n_ctx,
            "results": results,
            "tokens_per_s": {n: args.batch * args.seq_len
                             / (r["ms_per_pass"] / 1e3)
                             for n, r in results.items()},
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
