"""PyTorch and CUDA port of tpu_resiliency for NVIDIA Hopper (H100).

The JAX package ``tpu_resiliency`` is the reference; this package sits beside it and
imports nothing of it. Ported so far: the straggler vertical — the train-loop
callback (``integrations``), the ``Detector`` API with its rings, name registry and
interval tracker, per-kernel device times from ``torch.profiler``
(``telemetry.device_profiler``), the health policy, the device-resident ring
(``telemetry.sharded``, also over a ``torch.distributed`` process group), the
scoring pipeline (``telemetry.scoring``), reports (``telemetry.reporting``) and the
hand-written Hopper kernels of the window reduction (``ops.scoring_kernels``:
``loop``, ``pairwise`` and ``radix`` in ``csrc/``), with the H100 sweep that sets
their auto-selection (``ops.kernel_sweep``); and copies of the JAX-free support they
need (``exceptions``, ``utils.logging``, ``utils.events``, ``watchdog.data``).

Entry points run on the CUDA card by default and raise when there is none; pass
``device="cpu"`` to run the plain PyTorch path on the CPU.
"""

from tpu_resiliency_torch.ops.scoring_kernels import auto_mode, fused_median_weights
from tpu_resiliency_torch.telemetry.reporting import Report, ReportGenerator
from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry, TelemetryState

__all__ = [
    "MeshTelemetry",
    "Report",
    "ReportGenerator",
    "TelemetryState",
    "auto_mode",
    "fused_median_weights",
]
