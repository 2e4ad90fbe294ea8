"""The non-distributed control (reference Non-Distributed-Setup/): a plain
single-device trainer for the same model, loss and data stream as every
distributed example. Sync DP must match it to numerical precision, and
the determinism gate (``tests/test_torch_examples.py``) holds the mesh
topologies to this script's :func:`train`.

No mesh and no collectives: the MNIST CNN under ``torch.optim.SGD`` with
momentum 0.9 (the reference's gradient-descent loop) on one device::

    E=distributed_tensorflow_guide_tpu_torch.examples
    python -m $E.non_distributed --steps 200
    python -m $E.non_distributed --device cpu

``--fake-devices`` has no meaning for one device and is refused; the model
runs on the card (f32; no kernel of K1-K6 on its path).
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


def train(steps: int, global_batch: int, lr: float, seed: int = 0,
          log_every: int = 0, *, device=None, model=None) -> list[dict]:
    """Run the control trainer; returns the per-step metrics list.

    Importable (the determinism gate and the parity tests call it).
    ``device`` as ``core/device.resolve_device`` takes it (None: the
    card); ``model`` an ``MNISTCNN`` on that device holding the starting
    weights (default: ``init_weights(seed)``; ``bridge.mnist_cnn_from_flax``
    carries the JAX package's across).
    """
    from distributed_tensorflow_guide_tpu_torch.core.device import (
        resolve_device,
    )
    from distributed_tensorflow_guide_tpu_torch.data.synthetic import (
        synthetic_mnist,
    )
    from distributed_tensorflow_guide_tpu_torch.models.mnist_cnn import (
        MNISTCNN,
        make_loss_fn,
    )
    from distributed_tensorflow_guide_tpu_torch.parallel.grad_accum import (
        value_and_grad,
    )

    dev = resolve_device(device)
    if model is None:
        model = MNISTCNN().to(dev).init_weights(seed)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    loss_fn = make_loss_fn(model)

    metrics = []
    data = synthetic_mnist(global_batch, seed=seed)
    for i, batch in enumerate(data.take(steps)):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        (loss, mets), grads = value_and_grad(loss_fn, model, batch)
        for n, p in model.named_parameters():
            p.grad = grads[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        metrics.append({"loss": float(loss), **{k: float(v)
                                                 for k, v in mets.items()}})
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in metrics[-1].items()),
                  flush=True)
    return metrics


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    _common.add_device_args(ap)
    return ap


def run(args, *, model=None) -> dict:
    if args.fake_devices > 1:
        raise SystemExit("the non-distributed control runs on one device")
    dev = _common.device_of(args)
    before = _common.kernel_counts()
    clock = _common.Clock(dev)
    ms = train(args.steps, args.global_batch, args.lr, args.seed,
               args.log_every, device=dev, model=model)
    wall = clock.stop()
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"platform: {dev.type} ({n_dev} devices)")
    done = (f"done: {len(ms)} steps, final loss {ms[-1]['loss']:.4f}, "
            f"final accuracy {ms[-1]['accuracy']:.3f}")
    print(done, flush=True)
    return {"done": done, "device": str(dev), "metrics": ms,
            "wall_s": wall,
            "images_per_s": args.steps * args.global_batch / wall,
            "launches": _common.launches_since(before)}


def main(argv=None) -> dict:
    return _common.main(__file__, argv)


if __name__ == "__main__":
    main()
