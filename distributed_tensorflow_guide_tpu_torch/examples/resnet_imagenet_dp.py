"""Judged config 2: ResNet on ImageNet-shaped data, synchronous data
parallelism with BatchNorm statistics kept equal across ranks, and a
held-out evaluation.

Reference equivalent: MultiWorkerMirroredStrategy's NCCL all-reduce
around a Keras ResNet. Here the all-reduce is ``DataParallel``'s over the
``data`` axis (``--overlap on``: bucketed, issued mid-backward,
``parallel/overlap.py``), the running statistics are averaged after each
update (``make_train_step_with_stats``), and evaluation runs the same
ranks without gradients (``train/evaluation.py``). Pixels are synthetic
(class prototypes + noise)::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.resnet_imagenet_dp --steps 100     # ResNet-50/224
    python -m $E.resnet_imagenet_dp --steps 30 --fake-devices 8 \\
        --model small --image-size 32 --global-batch 64  # CPU smoke

``--fake-devices N``: N gloo ranks on the CPU, each on its share of the
global batch. bf16 convolutions through cuDNN; no kernel of K1-K6 runs.
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
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--model", choices=["resnet50", "small"],
                    default="resnet50",
                    help="small = ResNet18-ish, for CPU smoke runs")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out evaluation every N steps (always once at "
                         "the end); 0 = end-of-run only")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="optimizer steps a call (one CUDA graph on a "
                         "card); hooks still see every step's metrics")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="device-prefetch buffers: batch N+1 is copied to "
                         "the device while step N computes "
                         "(data/prefetch.py)")
    ap.add_argument("--overlap", choices=["auto", "on", "off"],
                    default="auto",
                    help="bucketed backward gradient all-reduce "
                         "(parallel/overlap.py; 'auto' = on over NCCL: "
                         "bitwise-identical gradients, the all-reduces "
                         "overlap the rest of the backward)")
    _common.add_device_args(ap)
    return ap


def run(args) -> dict:
    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.data.synthetic import (
        SyntheticClassification,
    )
    from distributed_tensorflow_guide_tpu_torch.models.resnet import (
        ResNet18ish,
        ResNet50,
        make_loss_fn,
        make_metric_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train import (
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
    ax = mesh.axis("data")
    n_dev = ax.size
    if args.global_batch % n_dev:
        raise SystemExit(f"--global-batch must divide by {n_dev} devices")

    def share(b):
        return _common.data_share(b, ax.index, n_dev)

    dp = DataParallel(mesh, overlap=args.overlap, device=dev)
    model_cls = ResNet50 if args.model == "resnet50" else ResNet18ish
    model = model_cls(num_classes=args.num_classes,
                      dtype=torch.bfloat16).to(dev).init_weights(0)
    # the running statistics are module buffers: the TrainState holds them
    state = TrainState(model, torch.optim.SGD(model.parameters(),
                                              lr=args.lr, momentum=0.9))
    k = args.steps_per_call
    loss_fn = make_loss_fn(model)
    step = dp.make_train_step_with_stats(
        loss_fn, steps_per_call=k if k > 1 else None, stacked_batch=k > 1,
        per_step_metrics=k > 1)
    # the input overlap stage: host batches packed k a call and copied to
    # the device ahead of the consumer
    shape = (args.image_size, args.image_size, 3)
    data = dp.prefetch(
        (share(b) for b in SyntheticClassification(
            args.global_batch, image_shape=shape,
            num_classes=args.num_classes)),
        depth=args.prefetch_depth, steps_per_call=k)
    eval_hook = None
    losses = _common.LossRecorder()
    hooks = [StopAtStepHook(args.steps), losses]
    if args.eval_batches > 0:
        eval_batches = [share(b) for b in SyntheticClassification(
            args.global_batch, image_shape=shape,
            num_classes=args.num_classes, sample_seed=10_001,
        ).take(args.eval_batches)]
        evaluator = Evaluator(
            dp.make_eval_step_with_stats(make_metric_fn(model)),
            lambda: eval_batches)
        eval_hook = EvalHook(evaluator, every_steps=args.eval_every,
                             name="resnet")
        hooks.append(eval_hook)
    if args.log_every:
        hooks += [LoggingHook(args.log_every),
                  StepCounterHook(args.log_every,
                                  batch_size=args.global_batch,
                                  n_chips=n_dev)]
    tail_step = dp.make_train_step_with_stats(loss_fn) if k > 1 else None
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    loop = TrainLoop(step, state, data, hooks=hooks, steps_per_call=k,
                     tail_step_fn=tail_step, device=dev)
    loop.run()
    wall = clock.stop()
    tail = ""
    if eval_hook is not None and eval_hook.latest:
        tail = (f"; held-out accuracy {eval_hook.latest['accuracy']:.4f} "
                f"(loss {eval_hook.latest['loss']:.4f})")
    done = (f"done: {loop.step} steps ({args.model}, {args.image_size}px) "
            f"on {n_dev} device(s); overlap={'on' if dp.overlap else 'off'}"
            f"; dispatches: {loop.dispatch_stats.as_dict()}"
            f"; prefetch: {data.stats.as_dict()}{tail}")
    print(done, flush=True)
    return {"done": done, "device": str(dev), "world": n_dev,
            "losses": losses.losses,
            "eval": eval_hook.latest if eval_hook is not None else None,
            "wall_s": wall,
            "images_per_s": loop.step * args.global_batch / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
