"""Hand-written Hopper kernels of the port and their plain PyTorch versions."""

from tpu_resiliency_torch.ops.scoring_kernels import (
    MODES,
    auto_mode,
    fused_median_weights,
    kernel_supported,
    max_auto_window,
    median_weights_pairwise_reference,
    median_weights_radix_reference,
    median_weights_reference,
    radix_auto_enabled,
    reset_launches,
)

__all__ = [
    "MODES",
    "auto_mode",
    "fused_median_weights",
    "kernel_supported",
    "max_auto_window",
    "median_weights_pairwise_reference",
    "median_weights_radix_reference",
    "median_weights_reference",
    "radix_auto_enabled",
    "reset_launches",
]
