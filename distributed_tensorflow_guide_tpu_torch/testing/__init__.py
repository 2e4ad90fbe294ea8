"""Test-support utilities shipped with the package (chaos harness)."""

from distributed_tensorflow_guide_tpu_torch.testing.chaos import (  # noqa: F401
    ChaosInjectedError,
    Fault,
    FaultSchedule,
    corrupt_checkpoint,
)
