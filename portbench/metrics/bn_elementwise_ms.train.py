"""Models (``models/resnet.py``): device ms a step in BatchNorm and
elementwise kernels, from the traced slice. A kernel counts when its
name holds one of ``CLASSES`` (PyTorch's elementwise, reduction,
normalisation and pooling kernels) and none of ``NOT`` (convolutions,
GEMMs, the optimizer's multi-tensor kernels, copies). Moves
``train_step_ms``."""

CLASSES = ("elementwise", "reduce_kernel", "batch_norm", "batchnorm",
           "welford", "pool", "softmax", "fill", "index", "CatArray")
NOT = ("xmma", "gemm", "cutlass", "conv", "cudnn", "multi_tensor_apply",
       "Memcpy", "Memset")


def is_bn_elementwise(name: str) -> bool:
    low = name.lower()
    return (any(c.lower() in low for c in CLASSES)
            and not any(n.lower() in low for n in NOT))


def read(run):
    tr, steps = run.get("trace"), run.get("trace_steps")
    if not tr or not steps:
        return None
    s = sum(sec for name, (_, sec) in tr["kernels"].items()
            if is_bn_elementwise(name))
    return 1e3 * s / steps if s > 0 else None
