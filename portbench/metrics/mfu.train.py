"""The whole step on the device: model FLOPs a step (closed form,
``cost/models.py``) over the step time of the window and the card's
989 TFLOP/s bf16 peak, %. Moves ``train_step_ms``."""

from portbench.cost import peaks


def read(run):
    if not run.get("steps"):
        return None
    return 100.0 * run["flops_per_step"] / (
        run["train_step_ms"] / 1e3) / peaks.H100_BF16_FLOPS
