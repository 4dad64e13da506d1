"""Device resolution, card identity and liveness, the torch.distributed lifecycle
(``distributed``), and copies of the coordination store (``store``, ``shardstore``,
``framing``, ``chaos``)."""

from tpu_resiliency_torch.platform.device import (
    card_name_and_power_limit,
    device_liveness_probe,
    local_device_count,
    platform_kind,
    resolve_device,
    visible_device_env,
)

__all__ = [
    "card_name_and_power_limit",
    "device_liveness_probe",
    "local_device_count",
    "platform_kind",
    "resolve_device",
    "visible_device_env",
]
