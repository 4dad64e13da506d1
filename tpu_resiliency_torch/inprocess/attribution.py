"""Interruption attribution: why a restart round started.

Analogue of reference ``inprocess/attribution.py:7-45``. Records are tiny picklable
tuples pushed into the coordination store's interruption list; every rank's monitor
thread reads them to log *why* it is restarting.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Interruption(enum.Enum):
    EXCEPTION = enum.auto()  # wrapped fn raised on this rank
    SOFT_TIMEOUT = enum.auto()  # progress timestamp stale past soft limit
    HARD_TIMEOUT = enum.auto()  # stale past hard limit; rank was signalled
    TERMINATED = enum.auto()  # rank deliberately terminated (policy / control request)
    UNRESPONSIVE = enum.auto()  # sibling heartbeat ring found the rank dead
    MONITOR_PROCESS_DEAD = enum.auto()  # rank's main process exited; monitor reported it
    RESTART_REQUESTED = enum.auto()  # explicit user-requested restart


@dataclasses.dataclass(frozen=True)
class InterruptionRecord:
    rank: int
    interruption: Interruption
    message: Optional[str] = None

    def describe(self) -> str:
        msg = f": {self.message}" if self.message else ""
        return f"rank {self.rank} {self.interruption.name}{msg}"
