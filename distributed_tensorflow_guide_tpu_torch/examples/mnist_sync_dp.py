"""Judged config 1: MNIST CNN, synchronous data parallelism.

Reference equivalents: Synchronous-SGD/ (SyncReplicasOptimizer) and the
MirroredStrategy surface. The same command runs everywhere: one card, N
ranks under the launcher, or N gloo ranks on the CPU::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.mnist_sync_dp --steps 200
    python -m $E.mnist_sync_dp --steps 200 --fake-devices 8
    D=distributed_tensorflow_guide_tpu_torch
    python -m $D.launch -n 2 --device cuda $D/examples/mnist_sync_dp.py \\
        --steps 200

``--fake-devices N``: N gloo ranks on the CPU. Each rank trains on its
share of the global batch (``DataParallel``'s all-reduce averages the
gradients); ``--data`` reads MNIST IDX files through the native loader;
``--ckpt-dir`` saves every 100 steps and resumes from the newest
checkpoint. No kernel of K1-K6 runs (f32 convolutions).
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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out evaluation every N steps (always once at "
                         "the end); 0 = end-of-run only")
    ap.add_argument("--eval-batches", type=int, default=8,
                    help="batches per evaluation pass")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="directory with the standard MNIST IDX files "
                         "(train-images-idx3-ubyte[.gz], ...); imported once "
                         "into the native record format and streamed by the "
                         "C++ loader. Default: synthetic MNIST-shaped data.")
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
        make_metric_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train import (
        CheckpointHook,
        Checkpointer,
        EvalHook,
        Evaluator,
        LoggingHook,
        StepCounterHook,
        StopAtStepHook,
        TrainLoop,
        TrainState,
    )

    dev = _common.device_of(args)
    mesh = build_mesh(MeshSpec(data=-1))
    data_ax = mesh.axis("data")
    n_dev = data_ax.size
    if args.global_batch % n_dev:
        raise SystemExit(f"--global-batch must divide by {n_dev} devices")

    def share(b):
        return _common.data_share(b, data_ax.index, n_dev)

    dp = DataParallel(mesh, device=dev)
    model = MNISTCNN().to(dev).init_weights(0)
    state = TrainState(model, torch.optim.SGD(model.parameters(),
                                              lr=args.lr, momentum=0.9))
    step = dp.make_train_step(make_loss_fn(model))
    make_eval_data = None
    if args.data:
        # real MNIST: IDX -> record file (once, by rank 0), then the native
        # mmap / shuffle / prefetch loader feeds training
        from distributed_tensorflow_guide_tpu_torch.data.importers import (
            MNIST_FIELDS,
            decode_mnist_batch,
            import_mnist,
        )
        from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
            open_record_loader,
        )

        rec = _common.chief_first(
            lambda: import_mnist(args.data, Path(args.data) / "records"))
        loader = open_record_loader(rec, MNIST_FIELDS, args.global_batch)
        print(f"native loader: {loader.num_records} records from {rec} "
              f"({type(loader).__name__})", flush=True)
        data = (share(decode_mnist_batch(b)) for b in loader)
        if args.eval_batches > 0:
            # data the optimizer never sees, in order, materialised once:
            # every pass sees the same batches, and a missing t10k split
            # is a notice here rather than a crash at the end
            try:
                eval_rec = _common.chief_first(lambda: import_mnist(
                    args.data, Path(args.data) / "records", split="test"))
                eval_loader = open_record_loader(
                    eval_rec, MNIST_FIELDS, args.global_batch, shuffle=False)
            except (FileNotFoundError, ValueError) as e:
                print(f"held-out evaluation disabled: {e}")
            else:
                n = min(args.eval_batches, eval_loader.batches_per_epoch)
                it = iter(eval_loader)
                eval_batches = [share(decode_mnist_batch(next(it)))
                                for _ in range(n)]
                eval_loader.close()

                def make_eval_data():
                    return eval_batches
    else:
        data = (share(b) for b in synthetic_mnist(args.global_batch))
        if args.eval_batches > 0:
            # held-out synthetic stream: the same class prototypes (the
            # same task), other sample draws
            eval_batches = [share(b) for b in synthetic_mnist(
                args.global_batch, sample_seed=10_001).take(
                    args.eval_batches)]

            def make_eval_data():
                return eval_batches

    eval_hook = None
    hooks = [StopAtStepHook(args.steps)]
    if make_eval_data is not None:
        evaluator = Evaluator(dp.make_eval_step(make_metric_fn(model)),
                              make_eval_data)
        eval_hook = EvalHook(evaluator, every_steps=args.eval_every,
                             name="mnist")
        hooks.append(eval_hook)
    if args.log_every:  # 0 = silent (smoke tests)
        hooks += [LoggingHook(args.log_every),
                  StepCounterHook(args.log_every,
                                  batch_size=args.global_batch,
                                  n_chips=n_dev)]
    start_step = 0
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir)
        if ckpt.latest_step() is not None:  # resume: restore + step counter
            start_step = ckpt.latest_step()
            ckpt.restore(state)
            print(f"resumed from step {start_step}", flush=True)
        hooks.append(CheckpointHook(ckpt, every_steps=100))

    losses = _common.LossRecorder()
    hooks.append(losses)
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    loop = TrainLoop(step, state, data, hooks=hooks, start_step=start_step,
                     device=dev)
    loop.run()
    wall = clock.stop()
    tail = ""
    if eval_hook is not None and eval_hook.latest:
        tail = (f"; held-out accuracy {eval_hook.latest['accuracy']:.4f} "
                f"(loss {eval_hook.latest['loss']:.4f})")
    done = (f"done: {loop.step} steps on {n_dev} device(s), mesh axes "
            f"{axis_sizes(mesh)}{tail}")
    print(done, flush=True)
    ran = loop.step - start_step
    return {"done": done, "device": str(dev), "world": n_dev,
            "losses": losses.losses,
            "eval": eval_hook.latest if eval_hook is not None else None,
            "wall_s": wall,
            "images_per_s": ran * args.global_batch / wall if ran else None,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
