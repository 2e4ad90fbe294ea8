"""The train state, hooks, loop, held-out evaluation, checkpoints and the
resilience layer (anomaly sentinel, recovery, preemption, the elastic
world)."""

from distributed_tensorflow_guide_tpu_torch.train.hooks import (  # noqa: F401
    BaseHook,
    Hook,
    LoggingHook,
    MetricsJSONLHook,
    StepCounterHook,
    StopAtStepHook,
)
from distributed_tensorflow_guide_tpu_torch.train.loop import TrainLoop  # noqa: F401
from distributed_tensorflow_guide_tpu_torch.train.state import TrainState  # noqa: F401
from distributed_tensorflow_guide_tpu_torch.train.anomaly import (  # noqa: F401
    AnomalyBudgetExceeded,
    AnomalyDetected,
    AnomalySentinelHook,
)
from distributed_tensorflow_guide_tpu_torch.train.checkpoint import (  # noqa: F401
    Checkpointer,
    CheckpointHook,
    LayoutMismatchError,
    StateMismatchError,
    WorldSizeMismatchError,
)
from distributed_tensorflow_guide_tpu_torch.train.elastic import (  # noqa: F401
    PreemptionHook,
    TooManyRestarts,
    run_with_recovery,
)
from distributed_tensorflow_guide_tpu_torch.train.evaluation import (  # noqa: F401
    Evaluator,
    EvalHook,
)
from distributed_tensorflow_guide_tpu_torch.train.elastic_world import (  # noqa: F401
    ElasticReport,
    ElasticSupervisor,
    ElasticWorldError,
    shard_bounds,
    verify_stream_accounting,
)
