"""Fault-tolerance callbacks: heartbeat-based and section-based workload monitoring.

Analogues of the reference's ``FaultToleranceCallback``
(``ptl_resiliency/fault_tolerance_callback.py:233-285`` heartbeats on every hook,
``:43-164`` the training state machine gating timeout recalculation, ``:297`` the
autoresume finished-flag file) and ``FaultToleranceSectionsCallback``
(``fault_tolerance_sections_callback.py:141-179`` — setup/step/checkpointing sections,
out-of-section covering the rest), re-hosted on the loop protocol of ``loop.py``.
"""

from __future__ import annotations

import os
from typing import Optional

from tpu_resiliency_torch.integrations.loop import Callback, LoopContext
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.watchdog.monitor_client import RankMonitorClient

log = get_logger(__name__)

FINISHED_FLAG_ENV = "TPU_FT_FINISHED_FLAG_FILE"


class SimulatedFault(BaseException):
    """Raised by the test-only ``simulated_fault_step`` hook. BaseException so the
    callback runner's "callback failures are never fatal" guard can't swallow it —
    a simulated fault must kill training like a real one (reference
    ``fault_tolerance_callback.py`` simulated-fault hook)."""


class _TrainingStateMachine:
    """Tracks enough loop history to decide (a) when observed heartbeat gaps are
    trustworthy inputs for timeout recalculation — at least two mid-training
    heartbeats and no exception seen — and (b) when training truly finished
    (reference ``_TrainingStateMachine``, ``fault_tolerance_callback.py:43-164``)."""

    def __init__(self):
        self.heartbeats = 0
        self.exception_seen = False
        self.finished = False

    def on_heartbeat(self) -> None:
        self.heartbeats += 1

    def on_exception(self) -> None:
        self.exception_seen = True

    def on_train_end(self, completed_all_steps: bool) -> None:
        self.finished = completed_all_steps and not self.exception_seen

    @property
    def can_update_timeouts(self) -> bool:
        return self.heartbeats >= 2 and not self.exception_seen


class FaultToleranceCallback(Callback):
    """Heartbeat on every step/validation/checkpoint hook; auto-calibrated timeouts
    persisted across restarts; finished-flag file for autoresume schedulers.

    ``state_dict_path``: where calculated timeouts are persisted (the reference keeps
    them in the PTL checkpoint; here a tiny sidecar JSON-ish pickle next to it).
    ``sync_store``: optional coordination store view for cross-rank MAX timeout sync.
    """

    def __init__(
        self,
        autoresume: bool = False,
        finished_flag_path: Optional[str] = None,
        state_dict_path: Optional[str] = None,
        calc_timeouts: bool = True,
        sync_store=None,
        simulated_fault_step: Optional[int] = None,
    ):
        self.client = RankMonitorClient()
        self.machine = _TrainingStateMachine()
        self.autoresume = autoresume
        self.finished_flag_path = finished_flag_path or os.environ.get(FINISHED_FLAG_ENV)
        self.state_dict_path = state_dict_path
        self.calc_timeouts = calc_timeouts
        self.sync_store = sync_store
        self.simulated_fault_step = simulated_fault_step
        self._timeouts_updated = False

    # -- hooks -------------------------------------------------------------

    def on_train_start(self, ctx: LoopContext) -> None:
        if self.autoresume and self.finished_flag_path and os.path.exists(self.finished_flag_path):
            log.info("finished flag present: training already done; stopping")
            ctx.should_stop = True
            return
        if self.state_dict_path and os.path.exists(self.state_dict_path):
            import pickle

            with open(self.state_dict_path, "rb") as f:
                self.client.load_state_dict(pickle.load(f))
        self.client.init_workload_monitoring()

    def _beat(self, ctx: LoopContext) -> None:
        if not self.client.is_initialized:
            return
        self.client.send_heartbeat()
        self.machine.on_heartbeat()
        if (
            self.simulated_fault_step is not None
            and ctx.step == self.simulated_fault_step
        ):
            raise SimulatedFault(f"simulated fault at step {ctx.step}")

    def on_step_end(self, ctx: LoopContext) -> None:
        self._beat(ctx)

    def on_validation_end(self, ctx: LoopContext) -> None:
        self._beat(ctx)

    def on_checkpoint_end(self, ctx: LoopContext) -> None:
        self._beat(ctx)
        self._maybe_update_timeouts(ctx)

    def on_exception(self, ctx: LoopContext, exc: BaseException) -> None:
        self.machine.on_exception()

    def on_train_end(self, ctx: LoopContext) -> None:
        # Only a full run is "finished": a cooperative stop (straggler eviction,
        # preemption) must NOT write the autoresume flag, or the scheduler would
        # abandon the remaining steps.
        completed = ctx.step >= ctx.max_steps
        self.machine.on_train_end(completed)
        if not self._timeouts_updated:
            self._maybe_update_timeouts(ctx)
        if self.machine.finished:
            flag_written = bool(self.autoresume and self.finished_flag_path)
            if flag_written:
                with open(self.finished_flag_path, "w") as f:
                    f.write("finished\n")
            # "finished" is a fact about the run, not about autoresume: emit
            # it whenever the machine says so; the flag path marks whether an
            # autoresume scheduler will also see it on disk.
            record_event(
                "ft", "training_finished",
                step=ctx.step,
                flag_path=self.finished_flag_path if flag_written else None,
            )
        if self.client.is_initialized:
            self.client.shutdown_workload_monitoring()

    # -- timeout persistence ----------------------------------------------

    def _maybe_update_timeouts(self, ctx: LoopContext) -> None:
        if not (self.calc_timeouts and self.machine.can_update_timeouts):
            return
        if not self.client.is_initialized:
            return
        try:
            self.client.calculate_and_set_hb_timeouts(
                store=self.sync_store, rank=ctx.rank, world_size=ctx.world_size
            )
            self._timeouts_updated = True
            hb = self.client.hb_timeouts
            record_event(
                "ft", "timeouts_calculated",
                step=ctx.step, initial_s=hb.initial, subsequent_s=hb.subsequent,
            )
            if self.state_dict_path:
                import pickle

                with open(self.state_dict_path, "wb") as f:
                    pickle.dump(self.client.state_dict(), f)
        except Exception:
            log.exception("timeout recalculation failed")


class FaultToleranceSectionsCallback(Callback):
    """Section-based monitoring: ``setup`` (train start → first step), ``step``
    (around each step), ``checkpointing`` (around checkpoint writes); everything
    else is out-of-section time, each with its own timeout."""

    SETUP = "setup"
    STEP = "step"
    CKPT = "checkpointing"

    def __init__(self, calc_timeouts: bool = True, sync_store=None):
        self.client = RankMonitorClient()
        self.calc_timeouts = calc_timeouts
        self.sync_store = sync_store
        self._setup_open = False
        self.machine = _TrainingStateMachine()

    def on_train_start(self, ctx: LoopContext) -> None:
        self.client.init_workload_monitoring()
        self.client.start_section(self.SETUP)
        self._setup_open = True

    def on_step_start(self, ctx: LoopContext) -> None:
        if not self.client.is_initialized:
            return
        if self._setup_open:
            self.client.end_section(self.SETUP)
            self._setup_open = False
        self.client.start_section(self.STEP)

    def on_step_end(self, ctx: LoopContext) -> None:
        if not self.client.is_initialized:
            return
        self.client.end_section(self.STEP)
        self.machine.on_heartbeat()

    def on_checkpoint_start(self, ctx: LoopContext) -> None:
        if not self.client.is_initialized:
            return
        self.client.start_section(self.CKPT)

    def on_checkpoint_end(self, ctx: LoopContext) -> None:
        if not self.client.is_initialized:
            return
        self.client.end_section(self.CKPT)

    def on_exception(self, ctx: LoopContext, exc: BaseException) -> None:
        self.machine.on_exception()
        if self.client.is_initialized:
            try:
                self.client.end_all_sections()
            except Exception:
                pass

    def on_train_end(self, ctx: LoopContext) -> None:
        if not self.client.is_initialized:
            return
        try:
            if self.calc_timeouts and self.machine.can_update_timeouts:
                self.client.calculate_and_set_section_timeouts(
                    store=self.sync_store, rank=ctx.rank, world_size=ctx.world_size
                )
        except Exception:
            log.exception("section timeout recalculation failed")
        finally:
            try:
                self.client.end_all_sections()
            except Exception:
                pass
            self.client.shutdown_workload_monitoring()
