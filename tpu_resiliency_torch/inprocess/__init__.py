"""In-process restart: recover from faults without killing the training process.

Port of ``tpu_resiliency/inprocess``: wrap the training function with
:class:`Wrapper`; on any fault the engine aborts, finalizes, health-checks, reassigns
ranks, and re-enters — skipping scheduler launch, container start, interpreter init,
and CUDA context creation on the recovery path. On the card the abort is
:class:`AbortTorchDistributed` (NCCL communicators aborted, process groups destroyed)
and the health check :class:`CudaHealthCheck`, where the reference exports
``AbortJaxDistributed`` and ``JaxHealthCheck``.
"""

from tpu_resiliency_torch.inprocess.abort import Abort, AbortCompilationCache, AbortTorchDistributed
from tpu_resiliency_torch.inprocess.attribution import Interruption, InterruptionRecord
from tpu_resiliency_torch.inprocess.completion import (
    Completion,
    LogCompletion,
    LogTerminate,
    Terminate,
)
from tpu_resiliency_torch.inprocess.compose import Compose, isinstance_or_composed
from tpu_resiliency_torch.inprocess.coordination import RestartCoordinator
from tpu_resiliency_torch.inprocess.finalize import Finalize, ThreadedFinalize
from tpu_resiliency_torch.inprocess.health_check import CudaHealthCheck, FaultCounter, HealthCheck
from tpu_resiliency_torch.inprocess.initialize import Initialize, RetryController
from tpu_resiliency_torch.inprocess.monitor_thread import MonitorThread, RankShouldRestart
from tpu_resiliency_torch.inprocess.monitor_process import MonitorConfig, MonitorProcess
from tpu_resiliency_torch.inprocess.nested_restarter import NestedRestarter
from tpu_resiliency_torch.inprocess.progress_watchdog import ProgressWatchdog
from tpu_resiliency_torch.inprocess.rank_assignment import (
    ActivateAllRanks,
    ActiveWorldSizeDivisibleBy,
    DemoteDegraded,
    FillGaps,
    FilterCountGroupedByKey,
    Layer,
    LayerFlag,
    MaxActiveWorldSize,
    RankAssignmentCtx,
    ShiftRanks,
    Tree,
)
from tpu_resiliency_torch.inprocess.state import FrozenState, Mode, State
from tpu_resiliency_torch.inprocess.wrap import CallWrapper, Wrapper

__all__ = [
    "Abort",
    "AbortCompilationCache",
    "AbortTorchDistributed",
    "ActivateAllRanks",
    "ActiveWorldSizeDivisibleBy",
    "CallWrapper",
    "Completion",
    "Compose",
    "CudaHealthCheck",
    "FaultCounter",
    "FillGaps",
    "FilterCountGroupedByKey",
    "Finalize",
    "FrozenState",
    "HealthCheck",
    "Initialize",
    "Interruption",
    "InterruptionRecord",
    "Layer",
    "LayerFlag",
    "LogCompletion",
    "LogTerminate",
    "DemoteDegraded",
    "MaxActiveWorldSize",
    "Mode",
    "MonitorConfig",
    "MonitorProcess",
    "MonitorThread",
    "NestedRestarter",
    "ProgressWatchdog",
    "RankAssignmentCtx",
    "RankShouldRestart",
    "RestartCoordinator",
    "RetryController",
    "ShiftRanks",
    "State",
    "Terminate",
    "ThreadedFinalize",
    "Tree",
    "Wrapper",
    "isinstance_or_composed",
]
