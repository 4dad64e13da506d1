"""Device resolution and card identity for the port."""

from tpu_resiliency_torch.platform.device import (
    card_name_and_power_limit,
    platform_kind,
    resolve_device,
)

__all__ = ["card_name_and_power_limit", "platform_kind", "resolve_device"]
