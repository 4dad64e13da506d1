from tpu_resiliency_torch.watchdog.config import FaultToleranceConfig
from tpu_resiliency_torch.watchdog.data import (
    HeartbeatTimeouts,
    RankInfo,
    SectionTimeouts,
    WorkloadAction,
    WorkloadControlRequest,
)
from tpu_resiliency_torch.watchdog.health import (
    CallbackHealthCheck,
    CudaRuntimeCheck,
    DeviceLivenessCheck,
    HealthCheck,
    HostMemoryCheck,
    IciLinkCheck,
    PeriodicHealthMonitor,
    SysfsCounterCheck,
)
from tpu_resiliency_torch.watchdog.monitor_client import RankMonitorClient
from tpu_resiliency_torch.watchdog.monitor_server import RankMonitorServer
from tpu_resiliency_torch.watchdog.state_machine import (
    LOG_MARKER,
    RestarterState,
    RestarterStateMachine,
)
from tpu_resiliency_torch.watchdog.timeouts import TimeoutsCalc

__all__ = [
    "FaultToleranceConfig",
    "HeartbeatTimeouts",
    "RankInfo",
    "SectionTimeouts",
    "WorkloadAction",
    "WorkloadControlRequest",
    "CallbackHealthCheck",
    "HostMemoryCheck",
    "IciLinkCheck",
    "CudaRuntimeCheck",
    "DeviceLivenessCheck",
    "HealthCheck",
    "PeriodicHealthMonitor",
    "SysfsCounterCheck",
    "RankMonitorClient",
    "RankMonitorServer",
    "LOG_MARKER",
    "RestarterState",
    "RestarterStateMachine",
    "TimeoutsCalc",
]
