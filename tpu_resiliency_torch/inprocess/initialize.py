"""Per-iteration initializers: gates that run before each (re)start of the wrapped fn.

Analogue of reference ``inprocess/initialize.py``: ``RetryController`` bounds restart
iterations and minimum world sizes, raising :class:`RestartAbort` to make the whole
wrapper give up (``initialize.py:53-93``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tpu_resiliency_torch.exceptions import RestartAbort
from tpu_resiliency_torch.inprocess.state import FrozenState
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class Initialize:
    def __call__(self, state: FrozenState) -> FrozenState:
        raise NotImplementedError


@dataclasses.dataclass
class RetryController(Initialize):
    max_iterations: Optional[int] = None
    min_world_size: int = 1
    min_active_world_size: int = 1

    def __call__(self, state: FrozenState) -> FrozenState:
        if self.max_iterations is not None and state.iteration >= self.max_iterations:
            raise RestartAbort(f"reached max_iterations={self.max_iterations}")
        if state.world_size < self.min_world_size:
            raise RestartAbort(
                f"world_size {state.world_size} < min_world_size {self.min_world_size}"
            )
        if (
            state.active_world_size is not None
            and state.active_world_size < self.min_active_world_size
        ):
            raise RestartAbort(
                f"active_world_size {state.active_world_size} < "
                f"min_active_world_size {self.min_active_world_size}"
            )
        return state
