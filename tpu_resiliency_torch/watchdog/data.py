"""Wire messages and shared types for the rank↔monitor↔launcher control plane.

A copy of ``tpu_resiliency/watchdog/data.py``, the one watchdog module the port
holds so far: the health policy's ``exclude_self_sink`` sends its
``WorkloadAction``. The monitor, its client and server are not ported yet.

Analogue of the reference's ``fault_tolerance/data.py`` (RankInfo ``:34``, timeout
bundles ``:71-138``, Init/Heartbeat/Section/UpdateConfig/Ok/Error messages ``:141-233``,
WorkloadAction + WorkloadControlRequest ``:236-260``). Messages travel as pickled frames
over filesystem-protected Unix sockets (``platform/ipc.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class RankInfo:
    global_rank: int
    local_rank: int
    host: str
    pid: int

    @staticmethod
    def of_current_process(global_rank: int, local_rank: int) -> "RankInfo":
        import os
        import socket

        return RankInfo(
            global_rank=global_rank,
            local_rank=local_rank,
            host=socket.gethostname(),
            pid=os.getpid(),
        )


@dataclasses.dataclass
class HeartbeatTimeouts:
    """Effective heartbeat timeouts; ``calculated`` marks auto-calibrated values
    (reference ``data.py:71``)."""

    initial: Optional[float] = None
    subsequent: Optional[float] = None
    calculated: bool = False

    @property
    def are_valid(self) -> bool:
        return self.initial is not None and self.subsequent is not None


@dataclasses.dataclass
class SectionTimeouts:
    """Per-section + out-of-section timeouts (reference ``data.py:104``)."""

    section: dict[str, Optional[float]] = dataclasses.field(default_factory=dict)
    out_of_section: Optional[float] = None
    calculated_sections: frozenset = frozenset()
    calculated_out_of_section: bool = False


class SectionAction(enum.Enum):
    OPEN = "open"
    CLOSE = "close"
    CLOSE_ALL = "close_all"


class WorkloadAction(enum.Enum):
    """Actions a rank can request from the launcher (reference ``data.py:236``)."""

    Continue = "continue"
    ExcludeThisNode = "exclude_this_node"
    ShutdownWorkload = "shutdown_workload"


@dataclasses.dataclass(frozen=True)
class WorkloadControlRequest:
    action: WorkloadAction
    sender: RankInfo
    reason: str = ""


# -- rank ↔ monitor messages ----------------------------------------------


@dataclasses.dataclass
class InitMsg:
    rank_info: RankInfo
    # client pushes any previously persisted state (calculated timeouts)
    client_state: Optional[dict] = None
    #: what forensics paths this rank supports (``{"dump_signal": bool,
    #: "dump_poll": bool}``). Read with ``getattr`` server-side — absent on
    #: old-build clients (version skew). ``dump_signal`` gates the monitor's
    #: SIGUSR1 nudge: the default SIGUSR1 disposition kills, so it is only
    #: sent to ranks that declared a handler.
    capabilities: Optional[dict] = None


@dataclasses.dataclass
class InitReplyMsg:
    config: Any  # effective FaultToleranceConfig
    hb_timeouts: HeartbeatTimeouts
    section_timeouts: SectionTimeouts


@dataclasses.dataclass
class HeartbeatMsg:
    rank: int
    timestamp: float = dataclasses.field(default_factory=time.monotonic)
    state: Optional[dict] = None  # optional piggy-backed client state
    #: last-known-location beacon (``utils/location.py`` snapshot). Optional
    #: and read with ``getattr`` server-side: a mixed old/new fleet during an
    #: in-job restart must interoperate in both directions (version skew).
    location: Optional[dict] = None


@dataclasses.dataclass
class SectionMsg:
    rank: int
    action: SectionAction
    name: Optional[str] = None
    timestamp: float = dataclasses.field(default_factory=time.monotonic)
    #: same skew contract as :class:`HeartbeatMsg.location`
    location: Optional[dict] = None


@dataclasses.dataclass
class DumpStacksMsg:
    """Ask a monitor to trigger an all-thread stack dump in its rank.

    Anyone holding the monitor socket may send it: the watchdog's sibling
    broadcast before the kill ladder, an operator tool, or a test. The
    monitor wakes the rank's parked :class:`WaitDumpMsg` long-poll (and
    nudges the rank with SIGUSR1 as a belt-and-braces second path)."""

    reason: str = "operator"


@dataclasses.dataclass
class WaitDumpMsg:
    """The rank's dump-listener long-poll: parks server-side until a dump is
    requested (``seen_gen`` differs from the server's dump generation) or
    ``timeout`` elapses. Reply is ``OkMsg(payload={"gen", "reason"})``; the
    client dumps whenever the generation moved."""

    seen_gen: int = 0
    timeout: float = 30.0


@dataclasses.dataclass
class StatusMsg:
    """Monitor introspection for the launcher's ``/hangz`` census: replies
    ``OkMsg(payload={rank, pid, last_hb_age_s, location, location_age_s,
    open_sections, terminated, ...})``."""


@dataclasses.dataclass
class UpdateTimeoutsMsg:
    hb_timeouts: Optional[HeartbeatTimeouts] = None
    section_timeouts: Optional[SectionTimeouts] = None


@dataclasses.dataclass
class OkMsg:
    payload: Optional[dict] = None


@dataclasses.dataclass
class ErrorMsg:
    error: str
