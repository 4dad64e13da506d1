"""The watchdog's shared message types (``watchdog/data.py``) and the restarter state
machine (``watchdog/state_machine.py``). The rank monitor, its client and server, the
health checks and the timeouts calculator are not ported yet (see ROADMAP.md)."""

from tpu_resiliency_torch.watchdog.data import (
    HeartbeatTimeouts,
    RankInfo,
    SectionTimeouts,
    WorkloadAction,
    WorkloadControlRequest,
)

__all__ = [
    "HeartbeatTimeouts",
    "RankInfo",
    "SectionTimeouts",
    "WorkloadAction",
    "WorkloadControlRequest",
]
