"""Kernels K1-K3 (``ops/csrc/flash_attention.cu``): their least time over
their summed device time in the traced slice, %. Least time a launch:
max(bytes / 3.35 TB/s, operations / 989 TFLOP/s) at the step's shapes
(``cost/kernels.py``). Moves ``train_step_ms``."""

from portbench.cost import kernels, peaks

KERNELS = {"flash_fwd_sm90": kernels.flash_fwd,
           "flash_dq_sm90": kernels.flash_dq,
           "flash_dkv_sm90": kernels.flash_dkv}


def read(run):
    tr, shapes = run.get("trace"), run.get("attn_shapes")
    if not tr or not shapes:
        return None
    dims = {k: shapes[k] for k in ("batch", "heads", "seq", "head_dim")}
    least = spent = 0.0
    for name, (count, sec) in tr["kernels"].items():
        for key, fn in KERNELS.items():
            if key in name:
                c = fn(**dims)
                least += count * peaks.least_seconds(c["flops"], c["bytes"])
                spent += sec
    return 100.0 * least / spent if spent > 0 else None
