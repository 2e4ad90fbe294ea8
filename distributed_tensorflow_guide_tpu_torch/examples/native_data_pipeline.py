"""End-to-end input pipeline: the native C++ record loader feeding
sync-DP training.

The native tier is ``data/native/dataloader.cpp`` (mmap, a global seeded
shuffle, threaded gather, a prefetch ring); the device tier is
``DataParallel``'s k-step train step (``steps_per_call``: k optimizer
steps a call, one CUDA graph on a card) fed by the device prefetch
(``data/prefetch.py``: pinned copies on a side stream)::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.native_data_pipeline --steps 100
    python -m $E.native_data_pipeline --steps 100 --fake-devices 8

``--fake-devices N``: N gloo ranks on the CPU; the loader shards the
records by rank and each rank draws its 1/N of the global batch. No
kernel of K1-K6 runs.
"""

import argparse
import itertools
import sys
import tempfile
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
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--records", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="device-side prefetch buffers (data/prefetch.py): "
                         "batch N+1 transfers while step N computes")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="optimizer steps per call (one CUDA graph on a "
                         "card); the host packs that many loader batches "
                         "into one stacked super-batch per call")
    _common.add_device_args(ap)
    return ap


def run(args) -> dict:
    import shutil

    from distributed_tensorflow_guide_tpu_torch.core.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_tensorflow_guide_tpu_torch.data import (
        make_fields,
        open_record_loader,
        write_records,
    )
    from distributed_tensorflow_guide_tpu_torch.data.synthetic import (
        synthetic_mnist,
    )
    from distributed_tensorflow_guide_tpu_torch.models.mnist_cnn import (
        MNISTCNN,
        make_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel import (
        DataParallel,
    )
    from distributed_tensorflow_guide_tpu_torch.train.state import TrainState

    dev = _common.device_of(args)
    n_proc, rank = world_and_rank()
    # 1. a record file from the synthetic source (the stand-in for a real
    #    dataset's conversion step), one per process
    fields = make_fields({"image": (np.float32, (28, 28, 1)),
                          "label": (np.int32, ())})
    full = next(iter(synthetic_mnist(args.records)))
    tmp = Path(tempfile.mkdtemp(prefix="native_data_pipeline_"))
    path = tmp / "mnist.records"
    write_records(path, {"image": full["image"], "label": full["label"]},
                  fields)
    # 2. the native loader shards by process: each draws its 1/n_proc of
    #    the global batch
    per_process_batch = args.global_batch // n_proc
    loader = open_record_loader(
        path, fields, per_process_batch, shard_id=rank, num_shards=n_proc,
        shuffle=True, seed=0, prefetch=4, n_threads=4)
    print(f"loader: {type(loader).__name__}, {loader.num_records} records, "
          f"{loader.batches_per_epoch} batches/epoch", flush=True)

    # 3. sync-DP training
    mesh = build_mesh(MeshSpec(data=-1))
    dp = DataParallel(mesh, device=dev)
    model = MNISTCNN().to(dev).init_weights(0)
    state = TrainState(model, torch.optim.SGD(model.parameters(),
                                              lr=args.lr))
    k = args.steps_per_call
    step = dp.make_train_step(make_loss_fn(model),
                              steps_per_call=k if k > 1 else None,
                              stacked_batch=k > 1, per_step_metrics=k > 1)

    # 4. the loader's prefetch ring hides the disk, the device prefetch
    #    the host-to-device copy, and k > 1 packs k batches a call.
    #    Exactly --steps optimizer steps run: full packs through the k-step
    #    call, the steps % k stragglers through a one-step sibling.
    n_full, n_tail = divmod(args.steps, k)
    source = (loader.next_batch() for _ in range(n_full * k))
    feed = dp.prefetch(source, depth=args.prefetch_depth, steps_per_call=k)
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    losses = []
    for s, batch in zip(itertools.count(), feed):
        state, metrics = step(state, batch)
        last = float(metrics["loss"][-1] if k > 1 else metrics["loss"])
        losses.append(last)
        if s % max(1, 20 // k) == 0 or (s == n_full - 1 and not n_tail):
            print(f"step {(s + 1) * k - 1:3d}  loss={last:.4f}", flush=True)
    if n_tail:
        tail_step = dp.make_train_step(make_loss_fn(model))
        for _ in range(n_tail):
            state, metrics = tail_step(state, loader.next_batch())
        losses.append(float(metrics["loss"]))
        print(f"step {args.steps - 1:3d}  loss={losses[-1]:.4f}",
              flush=True)
    wall = clock.stop()
    rate = args.steps * per_process_batch / wall
    stats = feed.stats.as_dict()
    print(f"{rate:.1f} examples/sec/process end-to-end (native input + "
          f"device step); overlap stats: {stats}", flush=True)
    loader.close()
    shutil.rmtree(tmp, ignore_errors=True)
    return {"done": f"loader: {type(loader).__name__}", "device": str(dev),
            "world": n_proc, "losses": losses, "wall_s": wall,
            "examples_per_s": rate, "prefetch": stats,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
