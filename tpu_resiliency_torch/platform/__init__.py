"""Device resolution, card identity, topology and liveness, the torch.distributed
lifecycle (``distributed``), the monitor channel (``ipc``, ``wire``), the compile
cache, and copies of the coordination store (``store``, ``shardstore``, ``framing``,
``chaos``)."""

from tpu_resiliency_torch.platform.device import (
    DeviceInfo,
    Topology,
    card_name_and_power_limit,
    device_liveness_probe,
    local_device_count,
    platform_kind,
    probe_topology,
    process_count,
    process_index,
    resolve_device,
    visible_device_env,
)

__all__ = [
    "DeviceInfo",
    "Topology",
    "card_name_and_power_limit",
    "device_liveness_probe",
    "local_device_count",
    "platform_kind",
    "probe_topology",
    "process_count",
    "process_index",
    "resolve_device",
    "visible_device_env",
]
