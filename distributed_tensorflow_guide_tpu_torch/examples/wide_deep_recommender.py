"""Judged config 4: Wide&Deep recommender, the reference's asynchronous
parameter servers replaced by a synchronous all-reduce.

Reference equivalent: the ParameterServerStrategy recommender workload
(embedding tables sharded across PS tasks, workers pushing sparse rows
asynchronously). Here every rank holds the tables whole in device memory
and all ranks update them in lockstep (``DataParallel``)::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.wide_deep_recommender --steps 300
    python -m $E.wide_deep_recommender --steps 300 --fake-devices 8

``--fake-devices N``: N gloo ranks on the CPU, each on its share of the
global batch. No kernel of K1-K6 runs.
"""

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from distributed_tensorflow_guide_tpu_torch.examples import (  # noqa: E402
    _common,
)

VOCABS = (100_000, 100_000, 10_000, 1000, 100)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--log-every", type=int, default=50)
    _common.add_device_args(ap)
    return ap


def build_model(device) -> torch.nn.Module:
    """The published widths: five id fields, 8 dense features, embeddings
    of 32, an MLP of 256 and 128."""
    from distributed_tensorflow_guide_tpu_torch.models.wide_deep import (
        WideDeep,
    )

    return WideDeep(vocab_sizes=VOCABS, num_dense=8, embed_dim=32,
                    mlp_dims=(256, 128)).to(device)


def run(args, *, model=None) -> dict:
    """``model``: a ``build_model`` module on the device holding the
    starting weights (default ``init_weights(0)``)."""
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        axis_sizes,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.data.synthetic import (
        SyntheticCTR,
    )
    from distributed_tensorflow_guide_tpu_torch.models.wide_deep import (
        make_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train import (
        LoggingHook,
        StepCounterHook,
        StopAtStepHook,
        TrainLoop,
        TrainState,
    )

    dev = _common.device_of(args)
    if model is None:
        model = build_model(dev).init_weights(0)
    n_params = sum(p.numel() for p in model.parameters())
    data = SyntheticCTR(args.global_batch, vocab_sizes=VOCABS, num_dense=8)
    mesh = build_mesh(MeshSpec(data=-1))
    ax = mesh.axis("data")
    dp = DataParallel(mesh, device=dev)
    state = TrainState(model, torch.optim.Adam(model.parameters(),
                                               lr=args.lr))
    losses = _common.LossRecorder()
    hooks = [StopAtStepHook(args.steps), losses]
    if args.log_every:
        hooks += [LoggingHook(args.log_every),
                  StepCounterHook(args.log_every,
                                  batch_size=args.global_batch,
                                  n_chips=ax.size)]
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    loop = TrainLoop(dp.make_train_step(make_loss_fn(model)), state,
                     (_common.data_share(b, ax.index, ax.size)
                      for b in data), hooks=hooks, device=dev)
    loop.run()
    wall = clock.stop()
    done = (f"done: {loop.step} steps, {n_params / 1e6:.1f}M params "
            f"(embeddings resident in HBM, no PS), mesh={axis_sizes(mesh)}")
    print(done, flush=True)
    return {"done": done, "device": str(dev), "world": ax.size,
            "losses": losses.losses, "wall_s": wall,
            "examples_per_s": loop.step * args.global_batch / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
