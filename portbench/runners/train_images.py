"""Image-classifier training through the port: ResNet-50 fed from
augmented records.

Set-up writes the mix's stored images and labels, drawn from the seed,
into a record file under ``$TMPDIR``; the port's ``NativeRecordLoader``
crops and flips them in its gather and ``DataParallel.prefetch`` takes
them to the card, where they are widened to float in [0, 1] (the record
format's one decode step). The step is
``DataParallel().make_train_step_with_stats(resnet.make_loss_fn(model))``
in ``TrainLoop``, eager, with cuDNN's autotuner as the mix sets it.
"""

from __future__ import annotations

import os
import tempfile

from portbench import generator, harness
from portbench.cost import models as cost_models
from portbench.runners import training
from portbench.reference import resnet as ref_resnet


def weight_specs(model, cfg: dict) -> dict:
    """(shape, std, mean) of each parameter: convolution and head kernels
    lecun-normal (std 1 / sqrt(fan in)); BatchNorm scales about 1 and
    shifts about 0 (std 0.1); the head's bias small. The last BatchNorm
    of a block scales as the configuration's ``last_bn_scale`` (mean,
    std) says: the zero-init recipe (Goyal et al., arXiv:1706.02677,
    section 5.1) starts it at 0 to keep each block near the identity,
    which would leave every other leaf of the block without a gradient at
    the first step."""
    last_mean, last_std = cfg["last_bn_scale"]
    specs = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if p.ndim > 1:
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
            specs[name] = (shape, fan_in ** -0.5, 0.0)
        elif name == "head.bias":
            specs[name] = (shape, 0.01, 0.0)
        elif name.endswith("bn2.weight"):
            specs[name] = (shape, float(last_std), float(last_mean))
        elif name.endswith("weight"):
            specs[name] = (shape, 0.1, 1.0)
        else:
            specs[name] = (shape, 0.1, 0.0)
    return specs


def _write_records(mix, seed, fields, write_records) -> str:
    fd, path = tempfile.mkstemp(prefix="portbench_images_",
                                suffix=".records")
    os.close(fd)
    for i, (pixels, labels) in enumerate(generator.image_records(mix,
                                                                 seed)):
        write_records(path, {"image": pixels, "label": labels}, fields,
                      append=i > 0)
    return path


def _tapped(source, taps: list, n: int):
    for batch in source:
        if len(taps) < n:
            taps.append({k: v.copy() for k, v in batch.items()})
        yield batch


def _widened(feed):
    for b in feed:
        yield {"image": b["image"].float().div_(255.0), "label": b["label"]}


def build(spec: dict, seed: int, dev) -> training.Built:
    import numpy as np
    import torch

    from distributed_tensorflow_guide_tpu_torch.data.native_loader import (
        ImageAugment,
        NativeRecordLoader,
        make_fields,
        write_records,
    )
    from distributed_tensorflow_guide_tpu_torch.models import resnet
    from distributed_tensorflow_guide_tpu_torch.parallel.data_parallel \
        import DataParallel
    from distributed_tensorflow_guide_tpu_torch.train.state import (
        TrainState,
    )

    cfg, mix = spec["config"], spec["mix"]
    torch.backends.cudnn.benchmark = bool(mix["cudnn_benchmark"])
    with torch.device(dev):
        model = resnet.ResNet(stage_sizes=tuple(cfg["stage_sizes"]),
                              num_classes=cfg["num_classes"],
                              num_filters=cfg["num_filters"],
                              dtype=getattr(torch, cfg["dtype"]))
    specs = weight_specs(model, cfg)
    w = harness.seeded_weights(specs, seed, dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    del w
    opt = mix["optimizer"]
    state = TrainState(model, torch.optim.SGD(
        model.parameters(), lr=opt["lr"], momentum=opt["momentum"]))
    dp = DataParallel(device=dev)
    step = dp.make_train_step_with_stats(resnet.make_loss_fn(model))

    stored = tuple(mix["stored"])
    fields = make_fields({"image": (np.uint8, stored),
                          "label": (np.int32, ())})
    path = _write_records(mix, seed, fields, write_records)
    aug = ImageAugment(in_shape=stored, crop=tuple(mix["crop"]),
                       hflip=bool(mix["hflip"]))
    loader = NativeRecordLoader(path, fields, int(mix["batch"]),
                                seed=seed & generator.SEED_MASK,
                                augment=aug,
                                n_threads=int(mix["loader_threads"]))
    taps: list = []
    prefetch = dp.prefetch(_tapped(loader, taps, int(mix["ref_steps"])),
                           depth=int(mix["prefetch_depth"]))

    def close():
        loader.close()
        os.remove(path)

    stages = tuple(cfg["stage_sizes"])

    def ref_loss(weights, batch, *, fp8=False, half=False):
        image = torch.as_tensor(batch["image"], device=dev).float() / 255.0
        label = torch.as_tensor(batch["label"], device=dev)
        if half:  # the fault: half of the batch, the mean over the rest
            image, label = image[: len(image) // 2], label[: len(label) // 2]
        return ref_resnet.loss(weights, image, label, stage_sizes=stages,
                               fp8=fp8)

    crop = mix["crop"][0]
    return training.Built(
        model=model, state=state, step=step, feed=_widened(prefetch),
        prefetch_stats=prefetch.stats, taps=taps, steps_per_call=1,
        ref_steps=int(mix["ref_steps"]),
        warm_steps=int(mix["warm_steps"]),
        trace_steps=int(mix["trace_steps"]),
        flops_per_step=cost_models.resnet_train_step_flops(
            stage_sizes=stages, num_filters=cfg["num_filters"], image=crop,
            num_classes=cfg["num_classes"], batch=int(mix["batch"])),
        attn_shapes=None, weight_specs=specs, ref_loss=ref_loss,
        close=close)


def run(spec, *, seed, seconds, trace, dev, t_start):
    return training.run(spec, build, seed=seed, seconds=seconds,
                        trace=trace, dev=dev, t_start=t_start)
