"""Fully-sharded data parallelism (FSDP / ZeRO-3): parameters and
optimizer moments sharded over the same ``data`` axis the batch is split
over (``parallel/fsdp.py``: each leaf gathered for the forward, its
gradient reduce-scattered in the backward).

Reference context: the guide's synchronous track replicates every
variable on every worker. FSDP is that strategy for models that outgrow
one device: the same sync-DP numerics, ~world-fold less resident state a
rank::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.fsdp_zero3 --fake-devices 8
    python -m $E.fsdp_zero3 --fake-devices 8 --layers 4 --d-model 512

``--fake-devices N``: N gloo ranks on the CPU; the printed local shard is
1/N of the embedding table. At ``--seq-len`` 64 attention is dense
(``attn_impl="auto"``): no kernel of K1-K6 runs.
"""

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_tensorflow_guide_tpu_torch.examples import (  # noqa: E402
    _common,
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--d-ff", type=int, default=512)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fused-ce", choices=["auto", "on", "off"],
                    default="auto",
                    help="chunked fused cross-entropy for the LM loss "
                         "(ops/fused_ce.py; 'auto' = on for a card and a "
                         "chunkable vocab)")
    ap.add_argument("--fsdp-prefetch", choices=["auto", "on", "off"],
                    default="auto",
                    help="the per-leaf gather schedule's prefetch knob "
                         "(parallel/overlap.py; 'auto' = on over NCCL; "
                         "both values run one schedule)")
    _common.add_device_args(ap)
    return ap


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        axis_sizes,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        make_lm_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.fsdp import FSDP
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    dev = _common.device_of(args)
    mesh = build_mesh(MeshSpec(data=-1))
    ax = mesh.axis("data")
    cfg = TransformerConfig(
        vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
        d_model=args.d_model, d_ff=args.d_ff, max_len=args.seq_len,
        causal=True, dtype=torch.float32)
    fsdp = FSDP(mesh, min_shard_size=2 ** 10, prefetch=args.fsdp_prefetch,
                device=dev)
    # the full model on the host; the rank keeps only its shards
    full = Transformer(cfg).init_weights(0)
    emb_numel = full.tok_emb.weight.numel()
    model = fsdp.shard(full)
    del full
    state = TrainState(model, torch.optim.Adam(model.parameters(),
                                               lr=args.lr))
    step = fsdp.make_train_step(make_lm_loss_fn(model,
                                                fused_ce=args.fused_ce))

    rng = np.random.RandomState(0)
    losses = []
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    for i in range(args.steps):
        # a learnable synthetic stream: next token = (token + 1) mod 16
        start = rng.randint(0, 16, (args.global_batch, 1))
        tokens = ((start + np.arange(cfg.max_len)) % 16).astype(np.int64)
        batch = _common.data_share({"tokens": tokens}, ax.index, ax.size)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}", flush=True)
    wall = clock.stop()
    first, last = losses[0], losses[-1]
    shard_frac = model.tok_emb.weight.numel() / emb_numel
    done = (f"done: loss {first:.3f} -> {last:.3f}, mesh={axis_sizes(mesh)}, "
            f"prefetch={'on' if fsdp.prefetch else 'off'}, "
            f"embedding sharding={fsdp.specs['tok_emb.weight']}, "
            f"local shard = {shard_frac:.3f} of the full table")
    print(done, flush=True)
    if args.steps >= 20 and not last < first:  # short runs may not yet
        raise AssertionError("loss did not improve")
    return {"done": done, "device": str(dev), "world": ax.size,
            "losses": losses, "shard_frac": shard_frac,
            "state_bytes": fsdp.state_bytes(model, state.optimizer),
            "wall_s": wall,
            "tokens_per_s": args.steps * args.global_batch * cfg.max_len
            / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
