"""PyTorch and CUDA port of tpu_resiliency for NVIDIA Hopper (H100).

The JAX package ``tpu_resiliency`` is the reference; this package sits beside it and
imports nothing of it. Ported so far: the straggler-telemetry hot loop — the
device-resident ring (``telemetry.sharded``), the scoring pipeline
(``telemetry.scoring``), reports (``telemetry.reporting``) and the hand-written
Hopper kernel for the window reduction (``ops.scoring_kernels``,
``csrc/median_weights.cu``).

Entry points run on the CUDA card by default and raise when there is none; pass
``device="cpu"`` to run the plain PyTorch path on the CPU.
"""

from tpu_resiliency_torch.ops.scoring_kernels import fused_median_weights
from tpu_resiliency_torch.telemetry.reporting import Report, ReportGenerator
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry, TelemetryState

__all__ = [
    "MeshTelemetry",
    "Report",
    "ReportGenerator",
    "TelemetryState",
    "fused_median_weights",
]
