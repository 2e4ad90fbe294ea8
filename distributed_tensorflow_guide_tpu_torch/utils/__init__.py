"""Utilities: dispatch accounting, matmul and convolution FLOPs, the
watchdog."""

from distributed_tensorflow_guide_tpu_torch.utils.watchdog import (  # noqa: F401
    DataStallError,
    Watchdog,
    WatchdogTimeout,
)
