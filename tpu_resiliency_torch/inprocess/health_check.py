"""Post-fault rank health checks.

Port of ``tpu_resiliency/inprocess/health_check.py``, whose ``JaxHealthCheck`` answers
the original ``CudaHealthCheck``: on the card the original comes back.
:class:`CudaHealthCheck` proves the device still answers with two probes, each a
tiny launch and a ``torch.cuda.synchronize``, each under a timeout thread. A kernel
that never ends blocks the synchronize, which the timeout thread turns into a
``HealthCheckError``; a sticky CUDA error (a trapped kernel) makes the launch or the
synchronize raise, which becomes one too. ``FaultCounter`` and ``HealthCheck`` are
copies.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

from tpu_resiliency_torch.exceptions import HealthCheckError
from tpu_resiliency_torch.inprocess.state import FrozenState
from tpu_resiliency_torch.platform.device import resolve_device, tiny_launch
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class HealthCheck:
    """Interface: called with the frozen state after finalize; raise to exclude rank."""

    def __call__(self, state: FrozenState) -> FrozenState:
        raise NotImplementedError


def _run_with_timeout(fn, timeout: float, what: str) -> None:
    err: list[BaseException] = []
    done = threading.Event()

    def body() -> None:
        try:
            fn()
        except BaseException as e:
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=body, name=f"health-{what}", daemon=True)
    t.start()
    if not done.wait(timeout):
        raise HealthCheckError(f"{what} did not complete within {timeout}s")
    if err:
        raise HealthCheckError(f"{what} failed: {err[0]!r}") from err[0]


@dataclasses.dataclass
class CudaHealthCheck(HealthCheck):
    """Device liveness probe: two tiny launches, each followed by a synchronize,
    each under a timeout. ``device=None`` means the card (raises at construction
    without one); ``device="cpu"`` runs the probes on the CPU, where they honour the
    dead-runtime mark of an injected ``DEVICE_ERROR``."""

    timeout: float = 30.0
    device: Any = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def __call__(self, state: FrozenState) -> FrozenState:
        def probe() -> None:
            tiny_launch(self.device)

        _run_with_timeout(probe, self.timeout, "device probe (1/2)")
        _run_with_timeout(probe, self.timeout, "device probe (2/2)")
        return state


@dataclasses.dataclass
class FaultCounter(HealthCheck):
    """Exclude a rank after too many faults (reference ``health_check.py:122-146``)."""

    max_rank_faults: Optional[int] = None

    def __post_init__(self) -> None:
        self._count = 0

    def __call__(self, state: FrozenState) -> FrozenState:
        # The health chain runs on EVERY survivor each restart round; only rounds
        # where THIS rank's fn raised count as this rank's faults.
        if state.fn_exception is None:
            return state
        self._count += 1
        if self.max_rank_faults is not None and self._count > self.max_rank_faults:
            raise HealthCheckError(
                f"rank {state.rank} exceeded {self.max_rank_faults} faults"
            )
        return state
