"""Layered-restart protocol glue: in-process restarter announces its state machine.

Analogue of reference ``inprocess/nested_restarter.py:34-107``: the in-process and
in-job restarters coordinate *by log-line contract* — machine-parseable
``[NestedRestarter] name=[InProcess] state=...`` lines that the in-job launcher's rank
monitor consumes (reference ``rank_monitor_state_machine.py:127-145``). The state
machine implementation is shared with the in-job side (``watchdog/state_machine.py``);
one :class:`NestedRestarter` owns it and exposes callbacks for the wrapper's plugin
slots so every transition is announced from the right place in the restart loop.
"""

from __future__ import annotations

from tpu_resiliency_torch.inprocess.state import FrozenState
from tpu_resiliency_torch.watchdog.state_machine import RestarterState, RestarterStateMachine


class NestedRestarter:
    """One per process; wire its callbacks into the Wrapper plugin slots:

    - ``.on_initialize`` → ``Wrapper.initialize`` (announces INITIALIZE on the first
      iteration, HANDLING_PROCESSING/COMPLETED when re-entering after a fault)
    - ``.on_abort`` → ``Wrapper.abort`` (announces HANDLING_START)
    - ``.on_completion`` → ``Wrapper.completion`` (announces FINALIZED)
    - ``.on_terminate`` → ``Wrapper.terminate`` (announces ABORTED)
    """

    def __init__(self, name: str = "InProcess"):
        # Non-strict: plugin slots may fire in fault-dependent orders (e.g. abort can
        # run twice when both the monitor and the local path handle a round).
        self.machine = RestarterStateMachine(name=name, strict=False)
        self.on_initialize = _Initialize(self)
        self.on_abort = _Abort(self)
        self.on_completion = _Completion(self)
        self.on_terminate = _Terminate(self)


class _Bound:
    def __init__(self, owner: NestedRestarter):
        self.owner = owner


class _Initialize(_Bound):
    def __call__(self, state: FrozenState) -> FrozenState:
        m = self.owner.machine
        if state.iteration == 0:
            m.initialize()
        else:
            if m.state == RestarterState.HANDLING_START:
                m.handling_processing(f"iteration={state.iteration}")
            if m.state == RestarterState.HANDLING_PROCESSING:
                m.handling_completed(f"iteration={state.iteration}")
        return state


class _Abort(_Bound):
    def __call__(self, state: FrozenState) -> FrozenState:
        if self.owner.machine.state != RestarterState.HANDLING_START:
            self.owner.machine.handling_start(f"iteration={state.iteration}")
        return state


class _Completion(_Bound):
    def __call__(self, state: FrozenState) -> FrozenState:
        self.owner.machine.finalized()
        return state


class _Terminate(_Bound):
    def __call__(self, state: FrozenState) -> FrozenState:
        self.owner.machine.aborted()
        return state
