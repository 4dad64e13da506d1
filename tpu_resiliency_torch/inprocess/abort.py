"""Abort: tear down distributed/device state so a faulted iteration can't wedge us.

Port of ``tpu_resiliency/inprocess/abort.py``. The reference answers the original
``AbortTorchDistributed`` (NCCL communicators aborted, then the process group
destroyed) with ``AbortJaxDistributed``; on the card the original design applies
again:

- :class:`AbortTorchDistributed` aborts the NCCL communicators of every process
  group, then destroys the groups (``platform.distributed.shutdown_for_restart``),
  so the restarted iteration can ``initialize`` a NEW world;
- :class:`AbortCompilationCache` drops torch's compiled programs
  (``torch.compiler.reset()``), which may be specialised to the old world.

A kernel truly stuck on the device has no abort path: the escalation ladder is the
reference's, soft (this abort) → hard (the monitor process signals the OS process;
its context dies with it, and the in-job launcher restarts it).
"""

from __future__ import annotations

import dataclasses

from tpu_resiliency_torch.inprocess.state import FrozenState
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class Abort:
    def __call__(self, state: FrozenState) -> FrozenState:
        raise NotImplementedError


@dataclasses.dataclass
class AbortTorchDistributed(Abort):
    """Abort the NCCL communicators of every process group, then destroy the groups,
    so the restarted iteration can ``initialize`` a NEW world.

    Requires the job to have initialized through
    :func:`tpu_resiliency_torch.platform.distributed.initialize` (recoverable: a
    failed communicator does not tear the process down before this abort can run).
    ``platform.distributed.last_abort_method`` records which abort the installed
    torch offered. Never raises.
    """

    def __call__(self, state: FrozenState) -> FrozenState:
        from tpu_resiliency_torch.platform import distributed

        # Never raises: the restart loop must proceed regardless.
        distributed.shutdown_for_restart()
        return state


@dataclasses.dataclass
class AbortCompilationCache(Abort):
    """Drop compiled programs that may be specialised to the previous world
    (``torch.compiler.reset()``: dynamo's and inductor's caches). A process that never
    loaded ``torch._dynamo`` compiled nothing, and the reset, which would import it
    (about 2 s on a CPU host), is skipped: the abort runs while the main thread still
    trains."""

    def __call__(self, state: FrozenState) -> FrozenState:
        import sys

        if "torch._dynamo" not in sys.modules:
            return state
        import torch

        try:
            torch.compiler.reset()
            log.info("abort: reset torch.compiler caches")
        except Exception as e:
            log.warning(f"abort: torch.compiler.reset failed: {e!r}")
        return state
