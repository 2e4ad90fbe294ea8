"""The async-PS family (reference Hogwild/, DOWNPOUR/, ADAG/): Hogwild ->
gossip, DOWNPOUR -> local SGD, ADAG -> accumulated adaptive, each one
flag of one program over the ranks (``parallel/async_ps.py``); the
``emulate-*`` modes run the reference's exact host semantics
(``parallel/ps_emulator.py``: one PS, 4 workers, seeded interleaving)::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.async_ps_family --algo hogwild --fake-devices 8
    python -m $E.async_ps_family --algo downpour --fake-devices 8
    python -m $E.async_ps_family --algo adag --fake-devices 8
    python -m $E.async_ps_family --algo emulate-hogwild

``--fake-devices N``: N gloo ranks on the CPU; each rank trains its
share of the global batch. Gossip mixes with two ring neighbours, which
are one rank at N = 2: run it at 4 or more. No kernel of K1-K6 runs.
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
    ap.add_argument("--algo", required=True,
                    choices=["hogwild", "downpour", "adag",
                             "emulate-hogwild", "emulate-downpour",
                             "emulate-adag"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--sync-period", type=int, default=4,
                    help="fetch_period equivalent for downpour/adag")
    ap.add_argument("--lr", type=float, default=0.05)
    _common.add_device_args(ap)
    return ap


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        axis_sizes,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.data.synthetic import (
        synthetic_mnist,
    )
    from distributed_tensorflow_guide_tpu_torch.models.mnist_cnn import (
        MNISTCNN,
        make_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.async_ps import (
        AccumulatedAdaptive,
        GossipSGD,
        LocalSGD,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.ps_emulator import (
        AsyncPSEmulator,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    dev = _common.device_of(args)
    model = MNISTCNN().to(dev).init_weights(0)
    loss_fn = make_loss_fn(model)
    before = _common.kernel_counts()

    if args.algo.startswith("emulate-"):
        mode = args.algo.removeprefix("emulate-")
        data = iter(synthetic_mnist(args.global_batch // 4))
        em = AsyncPSEmulator(loss_fn, model, n_workers=4, mode=mode,
                             lr=args.lr, fetch_period=args.sync_period,
                             device=dev)
        clock = _common.Clock(dev)
        losses = em.run(data, args.steps)
        wall = clock.stop()
        done = (f"{mode} emulation: loss {losses[0]:.3f} -> "
                f"{losses[-1]:.3f} ({em.pushes} PS pushes by 4 workers)")
        print(done, flush=True)
        return {"done": done, "device": str(dev), "losses": losses,
                "pushes": em.pushes, "wall_s": wall,
                "events_per_s": args.steps / wall,
                "launches": _common.launches_since(before)}

    mesh = build_mesh(MeshSpec(data=-1))
    ax = mesh.axis("data")
    opt = (torch.optim.Adam(model.parameters(), lr=1e-3)
           if args.algo == "adag"
           else torch.optim.SGD(model.parameters(), lr=args.lr,
                                momentum=0.9))
    state = TrainState(model, opt)
    data = iter(synthetic_mnist(args.global_batch))
    k = args.sync_period
    if args.algo == "hogwild":
        strat = GossipSGD(mesh, device=dev)
        state = strat.distribute(state)
        step = strat.make_train_step(loss_fn)

        def get_batch():
            return _common.data_share(next(data), ax.index, ax.size)

        rounds = args.steps
    else:
        cls = LocalSGD if args.algo == "downpour" else AccumulatedAdaptive
        strat = cls(mesh, k, device=dev)
        step = strat.make_train_step(loss_fn)

        def get_batch():
            bs = [next(data) for _ in range(k)]
            sb = {key: np.stack([b[key] for b in bs]) for key in bs[0]}
            return _common.data_share(sb, ax.index, ax.size, dim=1)

        rounds = args.steps // k

    losses = []
    clock = _common.Clock(dev)
    for r in range(rounds):
        state, m = step(state, get_batch())
        losses.append(float(m["loss"]))
        if r % max(rounds // 10, 1) == 0:
            print(f"round {r}: loss={losses[-1]:.4f}", flush=True)
    wall = clock.stop()
    if args.algo == "hogwild":
        w = strat.consensus(state)
        n = sum(x.numel() for x in w.values())
        print(f"consensus params: {n} weights averaged over "
              f"{axis_sizes(mesh)['data']} diverged replicas", flush=True)
    done = f"done: algo={args.algo} on {ax.size} device(s)"
    print(done, flush=True)
    images = rounds * (1 if args.algo == "hogwild" else k) * args.global_batch
    return {"done": done, "device": str(dev), "world": ax.size,
            "losses": losses, "wall_s": wall,
            "images_per_s": images / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
