"""Runtime observability plane: flight recorder, spans, metrics, recon.

Strictly observe-only and stdlib-only at import: nothing in this package
imports torch, and no instrumentation site feeds a step function or a
captured graph, so the recorder on or off leaves every engine and train
output bitwise the same (pinned in tests/test_torch_obs.py).
"""

from distributed_tensorflow_guide_tpu_torch.obs.events import (
    NULL_RECORDER,
    FlightRecorder,
    NullRecorder,
    ObsEvent,
    current,
    install,
    signature,
)
from distributed_tensorflow_guide_tpu_torch.obs.metrics import Registry
from distributed_tensorflow_guide_tpu_torch.obs.recon import (
    Roofline,
    reconcile,
)
from distributed_tensorflow_guide_tpu_torch.obs.tracing import (
    events_from_dump,
    span,
    to_chrome_trace,
    ttft_breakdown,
)

__all__ = [
    "FlightRecorder",
    "NullRecorder",
    "NULL_RECORDER",
    "ObsEvent",
    "Registry",
    "Roofline",
    "current",
    "events_from_dump",
    "install",
    "reconcile",
    "signature",
    "span",
    "to_chrome_trace",
    "ttft_breakdown",
]
