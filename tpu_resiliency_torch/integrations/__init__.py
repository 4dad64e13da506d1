"""Training-loop callbacks (the ``ptl_resiliency`` analogue): the loop protocol, the
fault-tolerance callbacks (heartbeats, sections), the straggler-detection callback and
the hierarchical checkpoint callback. The preemption and Orbax callbacks of the JAX
package are not ported yet (see ROADMAP.md)."""

from tpu_resiliency_torch.integrations.checkpoint_callback import HierarchicalCheckpointCallback
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
from tpu_resiliency_torch.integrations.straggler_callback import StragglerDetectionCallback

__all__ = [
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
