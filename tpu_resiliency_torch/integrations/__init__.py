"""Training-loop callbacks (the ``ptl_resiliency`` analogue): the loop protocol, the
fault-tolerance callbacks (heartbeats, sections), the straggler-detection callback, the
hierarchical checkpoint callback, preemption-synchronized saves, and the global
checkpoint tier on ``torch.distributed.checkpoint`` (the JAX package's orbax adapter,
as ``DcpCheckpointCallback``)."""

from tpu_resiliency_torch.integrations.checkpoint_callback import HierarchicalCheckpointCallback
from tpu_resiliency_torch.integrations.dcp_adapter import DcpCheckpointCallback
from tpu_resiliency_torch.integrations.ft_callbacks import (
    FaultToleranceCallback,
    FaultToleranceSectionsCallback,
)
from tpu_resiliency_torch.integrations.loop import (
    Callback,
    CallbackRunner,
    LoopContext,
    StopTraining,
    run_training,
)
from tpu_resiliency_torch.integrations.preemption import PreemptionCheckpointCallback
from tpu_resiliency_torch.integrations.straggler_callback import StragglerDetectionCallback

__all__ = [
    "DcpCheckpointCallback",
    "PreemptionCheckpointCallback",
    "Callback",
    "CallbackRunner",
    "LoopContext",
    "StopTraining",
    "run_training",
    "StragglerDetectionCallback",
    "HierarchicalCheckpointCallback",
    "FaultToleranceCallback",
    "FaultToleranceSectionsCallback",
]
