"""Terminal callbacks: run once when the wrapper finishes or gives up.

Analogues of reference ``inprocess/completion.py:27`` and ``terminate.py:24``.
"""

from __future__ import annotations

from tpu_resiliency_torch.inprocess.state import FrozenState
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class Completion:
    """Called once after the wrapped function returns successfully."""

    def __call__(self, state: FrozenState) -> FrozenState:
        raise NotImplementedError


class LogCompletion(Completion):
    def __call__(self, state: FrozenState) -> FrozenState:
        log.info(f"rank {state.rank}: wrapped function completed at iteration {state.iteration}")
        return state


class Terminate:
    """Called once when the restart loop aborts permanently (RestartAbort / fatal)."""

    def __call__(self, state: FrozenState) -> FrozenState:
        raise NotImplementedError


class LogTerminate(Terminate):
    def __call__(self, state: FrozenState) -> FrozenState:
        log.error(f"rank {state.rank}: restart loop terminated at iteration {state.iteration}")
        return state
