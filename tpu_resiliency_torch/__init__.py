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

The in-process restart slice: ``inprocess`` (the ``Wrapper`` restart loop, with
``AbortTorchDistributed`` and ``CudaHealthCheck``), ``platform.distributed`` (the
``torch.distributed`` lifecycle), the device liveness probe (``platform.device``),
device faults as CUDA kernels (``csrc/faults.cu`` behind
``inprocess.tools.inject_fault``), and copies of the store, framing, chaos, flight
recorder, tracing and state-machine modules they stand on.

The checkpoint slice: ``checkpoint`` (state dicts flattened in ``jax.tree_util``'s
order, pinned staging, the pipelined and blocking save engines, clique replication,
coding, the cold tier, the integrity ladder and reshard; containers interchange byte
for byte with the JAX package's) and ``integrations.checkpoint_callback``.

The fault-tolerance slice: ``watchdog`` (the rank monitor and its client, heartbeats
and sections, the timeouts calculator, the config, and the health checks with
``CudaRuntimeCheck``), ``integrations.ft_callbacks``, ``launcher`` (the in-job
restart launcher, ``python -m tpu_resiliency_torch.launcher.launch``, with its
rendezvous, worker groups and warm spares), ``platform.ipc`` over ``platform.wire``
(monitor frames that the JAX package's monitor reads, and back),
``platform.compile_cache`` (torch.compile's caches across restarts), and the worker
examples ``examples.resilient_training`` and ``examples.layered_restart``.

The model slice: ``models`` (the dense Llama-style ``Transformer`` and the ``MoE``,
trained with ``torch.optim.AdamW``), ``parallel.mesh`` over ``platform.device.make_mesh``
(DTensor placements over dp, tp and ep), ``integrations.preemption`` (every rank saves
at one agreed step after a SIGTERM notice), ``integrations.dcp_adapter`` (the global
checkpoint tier on ``torch.distributed.checkpoint``) and ``examples.preemption_train``.

The parallel model slice: ``parallel.ring_attention`` and ``parallel.pipeline`` over
``parallel.p2p`` (a differentiable neighbour shift and the pipeline's other
transposes), the examples ``moe_pipeline_training``, ``inprocess_restart_train`` and
``mesh_telemetry_training``, and ``scripts.bench_model`` (tokens/s and MFU).

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
