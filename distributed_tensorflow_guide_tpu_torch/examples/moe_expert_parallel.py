"""Expert parallelism (MoE), beyond the reference's strategy set.

The reference shards whole variables across PS tasks and moves them over
gRPC every step. EP shards whole experts over the ``expert`` mesh axis
and moves the tokens to them, one ``all_to_all`` each way
(``parallel/expert.py``)::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.moe_expert_parallel --fake-devices 8

``--fake-devices N``: N gloo ranks on the CPU; the expert axis takes the
largest size that divides both N and the expert count, ``data`` the
rest. f32 expert products; no kernel of K1-K6 runs.
"""

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_tensorflow_guide_tpu_torch.core.mesh import (  # noqa: E402
    world_and_rank,
)
from distributed_tensorflow_guide_tpu_torch.examples import (  # noqa: E402
    _common,
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--tokens", type=int, default=1024)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--num-experts", type=int, default=8)
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    _common.add_device_args(ap)
    return ap


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.expert import (
        ExpertParallel,
        MoEConfig,
        init_moe_params,
    )

    dev = _common.device_of(args)
    n_dev = world_and_rank()[0]
    n_exp_axis = min(args.num_experts, n_dev)
    while n_dev % n_exp_axis or args.num_experts % n_exp_axis:
        n_exp_axis -= 1
    cfg = MoEConfig(d_model=args.d_model, d_ff=4 * args.d_model,
                    num_experts=args.num_experts, top_k=args.top_k,
                    capacity_factor=1.5)
    mesh = build_mesh(MeshSpec(data=-1, expert=n_exp_axis))
    ep = ExpertParallel(mesh, cfg, device=dev)
    params = ep.shard_params(init_moe_params(
        cfg, torch.Generator().manual_seed(0)))
    step = ep.make_train_step(lr=args.lr)

    rng = np.random.RandomState(0)
    x = rng.randn(args.tokens, cfg.d_model).astype(np.float32)
    y = np.tanh(x @ (rng.randn(cfg.d_model, cfg.d_model) * 0.3).astype(
        np.float32))
    xs, ys = ep.token_shard(torch.as_tensor(x)), ep.token_shard(
        torch.as_tensor(y))
    losses = []
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    for s in range(args.steps):
        params, metrics = step(params, xs, ys)
        losses.append(float(metrics["loss"]))
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:3d}  loss={losses[-1]:.5f}  "
                  f"load_balance={float(metrics['load_balance']):.3f}  "
                  f"z={float(metrics['z_loss']):.3f}", flush=True)
    wall = clock.stop()
    done = (f"experts sharded {n_exp_axis}-way over {n_dev} devices; "
            "tokens moved via all_to_all, parameters never moved")
    print(done, flush=True)
    return {"done": done, "device": str(dev), "world": n_dev,
            "losses": losses, "wall_s": wall,
            "tokens_per_s": args.steps * args.tokens / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
