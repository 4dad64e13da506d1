"""In-job restarter state machine with the machine-parseable log-line contract.

Analogue of the reference's ``RankMonitorStateMachine``
(``fault_tolerance/rank_monitor_state_machine.py:98-145``): states with an
allowed-transition table, emitting ``[NestedRestarter] name=[InJob] state=... ...``
lines consumed by external watchers and by the layered-restart protocol that couples
the in-job and in-process restarters (``inprocess/nested_restarter.py:16-23``).
"""

from __future__ import annotations

import enum
import logging
from typing import Optional

from tpu_resiliency_torch.exceptions import InternalError
from tpu_resiliency_torch.utils.logging import get_logger

LOG_MARKER = "[NestedRestarter]"


class RestarterState(enum.Enum):
    UNINITIALIZED = "uninitialized"
    INITIALIZE = "initialize"
    HANDLING_START = "handling_start"
    HANDLING_PROCESSING = "handling_processing"
    HANDLING_COMPLETED = "handling_completed"
    FINALIZED = "finalized"
    ABORTED = "aborted"


_ALLOWED: dict[RestarterState, frozenset[RestarterState]] = {
    RestarterState.UNINITIALIZED: frozenset({RestarterState.INITIALIZE}),
    RestarterState.INITIALIZE: frozenset(
        {RestarterState.HANDLING_START, RestarterState.FINALIZED, RestarterState.ABORTED}
    ),
    RestarterState.HANDLING_START: frozenset(
        {RestarterState.HANDLING_PROCESSING, RestarterState.ABORTED}
    ),
    RestarterState.HANDLING_PROCESSING: frozenset(
        {RestarterState.HANDLING_COMPLETED, RestarterState.ABORTED}
    ),
    RestarterState.HANDLING_COMPLETED: frozenset(
        {RestarterState.HANDLING_START, RestarterState.FINALIZED, RestarterState.ABORTED}
    ),
    RestarterState.FINALIZED: frozenset(),
    RestarterState.ABORTED: frozenset(),
}


class RestarterStateMachine:
    """Tracks restarter state and logs every transition in the parseable format."""

    def __init__(
        self,
        name: str = "InJob",
        logger: Optional[logging.Logger] = None,
        strict: bool = True,
    ):
        self.name = name
        self.state = RestarterState.UNINITIALIZED
        self.strict = strict
        self._log = logger or get_logger(f"watchdog.restarter.{name}")

    def transition(self, new_state: RestarterState, detail: str = "") -> None:
        if new_state not in _ALLOWED[self.state]:
            msg = f"restarter {self.name}: illegal transition {self.state.name} → {new_state.name}"
            if self.strict:
                raise InternalError(msg)
            self._log.warning(msg)
        self.state = new_state
        line = f"{LOG_MARKER} name=[{self.name}] state={new_state.value}"
        if detail:
            line += f" {detail}"
        self._log.info(line)

    # convenience transitions mirroring the reference protocol
    def initialize(self):
        self.transition(RestarterState.INITIALIZE)

    def handling_start(self, detail: str = ""):
        self.transition(RestarterState.HANDLING_START, detail)

    def handling_processing(self, detail: str = ""):
        self.transition(RestarterState.HANDLING_PROCESSING, detail)

    def handling_completed(self, detail: str = ""):
        self.transition(RestarterState.HANDLING_COMPLETED, detail)

    def finalized(self, detail: str = ""):
        self.transition(RestarterState.FINALIZED, detail)

    def aborted(self, detail: str = ""):
        self.transition(RestarterState.ABORTED, detail)
