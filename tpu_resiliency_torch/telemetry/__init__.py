"""Straggler telemetry on the device: ring ingestion, scoring and reports."""

from tpu_resiliency_torch.telemetry.convert import (
    telemetry_state_from_numpy,
    telemetry_state_to_numpy,
)
from tpu_resiliency_torch.telemetry.reporting import (
    Report,
    ReportGenerator,
    StragglerId,
    Stragglers,
)
from tpu_resiliency_torch.telemetry.scoring import (
    TelemetryScores,
    masked_median,
    masked_total,
    score_round,
    score_summary,
    scores_to_host,
)
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry, TelemetryState

__all__ = [
    "MeshTelemetry",
    "Report",
    "ReportGenerator",
    "StragglerId",
    "Stragglers",
    "TelemetryScores",
    "TelemetryState",
    "masked_median",
    "masked_total",
    "score_round",
    "score_summary",
    "scores_to_host",
    "telemetry_state_from_numpy",
    "telemetry_state_to_numpy",
]
