"""Hand-written Hopper kernels of the port and their plain PyTorch versions."""

from tpu_resiliency_torch.ops.scoring_kernels import (
    fused_median_weights,
    kernel_supported,
    median_weights_reference,
)

__all__ = ["fused_median_weights", "kernel_supported", "median_weights_reference"]
