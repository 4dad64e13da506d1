"""Training-loop callbacks (the ``ptl_resiliency`` analogue): the loop protocol and
the straggler-detection callback. The fault-tolerance, checkpoint and preemption
callbacks of the JAX package are not ported yet (see ROADMAP.md)."""

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
]
