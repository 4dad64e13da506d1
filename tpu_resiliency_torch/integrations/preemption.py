"""Preemption-synchronized checkpointing: turn a preemption notice into one
agreed-upon save point across every rank.

Port of ``tpu_resiliency/integrations/preemption.py``. Schedulers deliver a
preemption notice as SIGTERM with a grace window, to one rank or to some. A per-rank
"save on SIGTERM" writes shards from different steps, which is not a checkpoint; the
save has to land at one step on every rank. The reference asks the JAX coordination
service's preemption sync manager (``multihost_utils.reached_preemption_sync_point``);
here the agreement is the process group's:

- :func:`install_notice_handler` (run at the callback's first agreement, or earlier by
  the caller) makes SIGTERM set a host flag in this process instead of ending it;
- every step, :meth:`PreemptionCheckpointCallback._reached` runs one
  ``all_reduce(MAX)`` of that flag over a **gloo group of host tensors** (the default
  group when it is gloo, else a gloo group made beside it once per default group), so
  no step pays a device synchronize, even on the card. The collective runs at the same
  step on every rank, so every rank sees the notice at the same step: the first step
  whose reduction holds any rank's flag.

Without an initialized process group the callback is a no-op, as the reference is
without a distributed client. Since the handler takes SIGTERM, an in-process
``Wrapper`` around a loop with this callback should terminate a hung rank with another
signal (``termination_signal=signal.SIGKILL``). Measured end to end on the CPU in
``tests/test_torch_preemption.py``: SIGTERM to one of two gloo ranks, both save the
same step and stop.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Any, Callable, Optional

import torch

from tpu_resiliency_torch.integrations.loop import Callback, LoopContext
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Set by the SIGTERM handler (or :func:`notify`); cleared by :func:`rescind`.
_notice = threading.Event()
_handler_installed = False
#: The gloo group the agreement runs on, for the default group it was made beside.
_agreement: dict = {}


def install_notice_handler() -> bool:
    """Make SIGTERM set this process's preemption flag instead of ending it. Only
    the main thread may install a handler: elsewhere this logs and returns False."""
    global _handler_installed
    if _handler_installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _on_notice)
    except ValueError:
        log.warning("preemption notice handler not installed: not the main thread")
        return False
    _handler_installed = True
    return True


def _on_notice(signum, frame) -> None:
    _notice.set()


def notify() -> None:
    """Raise this process's preemption flag, as the notice's signal does."""
    _notice.set()


def rescind() -> None:
    """Clear this process's preemption flag: the scheduler withdrew the notice."""
    _notice.clear()


def agreement_group():
    """The gloo group the agreement reduces over: the default group when it is gloo,
    else a gloo group of the default group's ranks, made once per default group
    (every rank must reach the first call together, as the callback's first step
    does)."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if dist.get_backend(world) == "gloo":
        return world
    if _agreement.get("world") is not world:
        _agreement.update(world=world, group=dist.new_group(backend="gloo"))
    return _agreement["group"]


class PreemptionCheckpointCallback(Callback):
    """Agree each step, over the process group, on whether any rank holds a
    preemption notice; on the agreed step, run ``on_preemption(state, step)``
    (typically a blocking save — the grace window is short) and cooperatively stop
    the loop.

    ``stop_on_preemption=False`` keeps training (save-and-continue — useful when
    the scheduler sometimes cancels the reclamation).

    ``grace_steps=N`` defers the drain/save/stop by N steps after the notice is first
    agreed — the **rescind window**. A notice that clears (:func:`rescind` on every
    rank that held it) before the window elapses emits one ``preemption_rescinded``
    event, cancels the pending deferred drain (it simply never runs), and re-arms the
    callback for a later real notice. The default (0) acts immediately.

    ``ckpt_manager`` (anything with ``maybe_finalize(blocking=True)`` — a
    :class:`~tpu_resiliency_torch.checkpoint.local_manager.LocalCheckpointManager`,
    an :class:`~tpu_resiliency_torch.checkpoint.async_ckpt.AsyncCheckpointer`, or a
    bare callable) defers acting on a notice that lands DURING an in-flight async
    save: the callback first drains the pending save to its commit/rename, THEN runs
    ``on_preemption``. Without the drain, the grace-window save races the background
    writer.

    The notice is SIGTERM, handled from the first agreement on; call
    :func:`install_notice_handler` earlier to take notices before the first step.

    After the loop stops, tear the process group down coordinator-last before
    process exit — :func:`platform.distributed.shutdown_ordered` (store-backed,
    deterministic) or :func:`shutdown_graceful` (store-free) — or a peer's
    teardown can race the rendezvous host's death.
    """

    def __init__(
        self,
        on_preemption: Callable[[Any, int], None],
        stop_on_preemption: bool = True,
        ckpt_manager: Any = None,
        grace_steps: int = 0,
    ):
        if grace_steps < 0:
            raise ValueError("grace_steps must be >= 0")
        self.on_preemption = on_preemption
        self.stop_on_preemption = stop_on_preemption
        self.ckpt_manager = ckpt_manager
        self.grace_steps = grace_steps
        self.preempted_at: Optional[int] = None  # last fired sync step
        self.rescinded: int = 0  # notices withdrawn before the grace elapsed
        self._armed = True
        #: step at which the current (armed) notice was first observed; the
        #: drain/save is deferred until ``grace_steps`` later — the window a
        #: rescind can cancel it in
        self._pending_since: Optional[int] = None

    def _drain_inflight_saves(self, step: int) -> None:
        """Block until any in-flight async save has committed (rename done,
        coverage finalized) before the preemption save runs. Failures are
        logged, not raised — a broken background save must not eat the grace
        window the final save needs."""
        mgr = self.ckpt_manager
        if mgr is None:
            return
        t0 = time.monotonic()
        try:
            if callable(getattr(mgr, "maybe_finalize", None)):
                mgr.maybe_finalize(blocking=True)
            elif callable(mgr):
                mgr()
        except Exception:
            log.exception(
                "draining in-flight async save before the preemption save "
                "failed; saving anyway"
            )
            record_event(
                "preemption", "preemption_drain", step=step, ok=False,
                duration_s=time.monotonic() - t0,
            )
            return
        record_event(
            "preemption", "preemption_drain", step=step, ok=True,
            duration_s=time.monotonic() - t0,
        )

    @staticmethod
    def _reached(step: int) -> bool:
        """Whether any rank holds a notice, agreed at this step by every rank: one
        ``all_reduce(MAX)`` of the host flag on the gloo group."""
        from tpu_resiliency_torch.platform.distributed import client_active

        if not client_active():
            return False  # no process group: nothing to agree with
        import torch.distributed as dist

        install_notice_handler()

        flag = torch.tensor([1 if _notice.is_set() else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=agreement_group())
        return bool(flag.item())

    def on_step_end(self, ctx: LoopContext) -> None:
        # Edge-triggered: fire once per notice, re-arm when the sync manager
        # stops reporting the point (save-and-continue jobs must catch a LATER
        # preemption; note upstream's sync manager handles one preemption per
        # process lifetime as of jax 0.9 — a second notice then simply keeps
        # the point asserted and no re-fire happens).
        reached = self._reached(ctx.step)
        if not reached:
            if self._pending_since is not None:
                # The notice cleared inside the grace window: the scheduler
                # withdrew the reclamation. Cancel the pending deferred
                # drain/save (it never runs) and re-arm for a real one.
                self.rescinded += 1
                log.warning(
                    f"preemption notice from step {self._pending_since} "
                    f"rescinded at step {ctx.step}: cancelling the deferred "
                    f"drain/save"
                )
                record_event(
                    "preemption", "preemption_rescinded", step=ctx.step,
                    noticed_step=self._pending_since, rank=ctx.rank,
                )
                self._pending_since = None
            self._armed = True
            return
        if not self._armed:
            return
        if self._pending_since is None:
            self._pending_since = ctx.step
            record_event(
                "preemption", "preemption_sync_point", step=ctx.step,
                rank=ctx.rank,
            )
        if ctx.step - self._pending_since < self.grace_steps:
            return  # rescind window still open: the drain/save stays deferred
        self._armed = False
        self._pending_since = None
        self.preempted_at = ctx.step
        log.warning(
            f"preemption sync point at step {ctx.step}: saving before the grace "
            f"window closes"
        )
        # A notice landing mid-async-save must wait for the commit/rename:
        # otherwise the final save and the background writer interleave and
        # the "latest" iteration at shrink time can be torn.
        self._drain_inflight_saves(ctx.step)
        self.on_preemption(ctx.state, ctx.step)
        if self.stop_on_preemption:
            ctx.should_stop = True
