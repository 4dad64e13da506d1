"""Finalizers: user cleanup run after a fault, before the health check.

Analogue of reference ``inprocess/finalize.py``: ``ThreadedFinalize`` runs the user's
cleanup function in a thread with a timeout so a wedged cleanup cannot hang the
restart loop (``finalize.py:64-108``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

from tpu_resiliency_torch.exceptions import InternalError
from tpu_resiliency_torch.inprocess.state import FrozenState


class Finalize:
    def __call__(self, state: FrozenState) -> FrozenState:
        raise NotImplementedError


@dataclasses.dataclass
class ThreadedFinalize(Finalize):
    timeout: float
    fn: Callable[..., Any]
    args: tuple = ()
    kwargs: Optional[dict] = None

    def __call__(self, state: FrozenState) -> FrozenState:
        err: list[BaseException] = []
        done = threading.Event()

        def body() -> None:
            try:
                self.fn(*self.args, **(self.kwargs or {}))
            except BaseException as e:
                err.append(e)
            finally:
                done.set()

        t = threading.Thread(target=body, name="inprocess-finalize", daemon=True)
        t.start()
        if not done.wait(self.timeout):
            raise InternalError(f"finalize did not complete within {self.timeout}s")
        if err:
            raise InternalError(f"finalize raised: {err[0]!r}") from err[0]
        return state
