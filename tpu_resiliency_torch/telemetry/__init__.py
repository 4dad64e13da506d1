"""Straggler telemetry on the device: the Detector API, rings, device-time
profiling, scoring, reports and the health policy.

The JAX package's ``score_round_jit``, ``make_sharded_scorer`` and
``score_round_sharded`` compile the pipeline over a mesh; the port has no copy of
them: ``score_round(group=...)`` and ``MeshTelemetry(group=...)`` answer them.
"""

from tpu_resiliency_torch.telemetry.convert import (
    telemetry_state_from_numpy,
    telemetry_state_to_numpy,
)
from tpu_resiliency_torch.telemetry.detector import CallableId, Detector
from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler
from tpu_resiliency_torch.telemetry.interval_tracker import ReportIntervalTracker
from tpu_resiliency_torch.telemetry.name_registry import NameRegistry
from tpu_resiliency_torch.telemetry.policy import (
    HealthDecision,
    HealthVectorPolicy,
    coordinator_sink,
    exclude_self_sink,
)
from tpu_resiliency_torch.telemetry.reporting import (
    Report,
    ReportGenerator,
    StragglerId,
    Stragglers,
)
from tpu_resiliency_torch.telemetry.ring_buffer import DeviceRings, HostRingBuffer
from tpu_resiliency_torch.telemetry.scoring import (
    TelemetryScores,
    masked_median,
    masked_total,
    robust_z,
    score_round,
    score_summary,
    scores_to_host,
)
from tpu_resiliency_torch.telemetry.sharded import (
    MeshTelemetry,
    TelemetryState,
    select_kernel_mode,
)
from tpu_resiliency_torch.telemetry.statistics import ALL_STATISTICS, Statistic, compute_stats

__all__ = [
    "CallableId",
    "Detector",
    "DeviceTimeProfiler",
    "ReportIntervalTracker",
    "NameRegistry",
    "Report",
    "ReportGenerator",
    "StragglerId",
    "Stragglers",
    "DeviceRings",
    "HostRingBuffer",
    "TelemetryScores",
    "MeshTelemetry",
    "TelemetryState",
    "HealthDecision",
    "HealthVectorPolicy",
    "coordinator_sink",
    "exclude_self_sink",
    "masked_median",
    "masked_total",
    "robust_z",
    "score_round",
    "score_summary",
    "scores_to_host",
    "select_kernel_mode",
    "Statistic",
    "ALL_STATISTICS",
    "compute_stats",
    "telemetry_state_from_numpy",
    "telemetry_state_to_numpy",
]
