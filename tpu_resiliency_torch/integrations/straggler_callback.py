"""Straggler-detection callback: per-step section timing + periodic scored reports.

Port of ``tpu_resiliency/integrations/straggler_callback.py``, the analogue of the
reference's ``StragglerDetectionCallback``
(``ptl_resiliency/straggler_det_callback.py``): the loop hooks bracket the step in a
detection section, call ``generate_report_if_interval_elapsed`` each step, log
best/worst scores, export per-rank scores into ``ctx.metrics``, and optionally
request a cooperative stop when stragglers are found (``trainer.should_stop``)."""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from tpu_resiliency_torch.integrations.loop import Callback, LoopContext
from tpu_resiliency_torch.telemetry.detector import Detector
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)


class StragglerDetectionCallback(Callback):
    def __init__(
        self,
        report_time_interval: float = 300.0,
        calc_relative_scores: bool = True,
        calc_individual_scores: bool = False,
        threshold: float = 0.75,
        stop_if_detected: bool = False,
        export_metrics: bool = True,
        profiling_interval: int = 1,
        section_name: str = "train_step",
        store=None,
        use_kernel: bool = False,
        health_policy=None,
        use_device_mesh: bool = False,
        mesh_signal_capacity: int = 16,
        profile_programs_every: Optional[int] = None,
        profile_ops: bool = False,
        max_signals: int = 64,
        device=None,
    ):
        """``device``: where the Detector scores and the profiler reads (``None`` means
        the CUDA card and raises without one; ``"cpu"`` the plain path).

        ``health_policy``: an optional
        :class:`~tpu_resiliency_torch.telemetry.policy.HealthVectorPolicy` fed every
        report.

        ``profile_programs_every``: every Nth step, bracket the step in a
        ``torch.profiler`` window (:class:`DeviceTimeProfiler`) and feed the device
        span of each ``record_function`` region run in it into the scored matrix as
        ``prog/...`` signals. Tracing is not free — use O(100). A window that fails
        to start raises from ``on_step_start``; the loop's callback runner logs it,
        and the step runs untimed.

        ``profile_ops``: with ``profile_programs_every``, also feed each kernel's
        device duration from the same windows as ``op/<kernel>`` signals (the
        reference's per-kernel CUPTI stream). Every kernel name is a column of the
        Detector's ``max_signals`` (default 64): a real model's step runs more kernels
        than that and needs a larger ``max_signals``. With ``use_device_mesh`` the op
        signals count against ``mesh_signal_capacity`` like every other column; the
        first over-capacity report drops the group path for the run and falls back
        to the store gather (logged, training never interrupted).

        ``use_device_mesh``: route report rounds through a
        :class:`~tpu_resiliency_torch.telemetry.sharded.MeshTelemetry` over the
        default process group, one row per rank, instead of the per-rank store
        gather. Requires ``torch.distributed`` initialized with ``world_size``
        processes; otherwise the callback logs once and takes the store path."""
        self.threshold = threshold
        self.stop_if_detected = stop_if_detected
        self.export_metrics = export_metrics
        self.section_name = section_name
        self.health_policy = health_policy
        self.use_device_mesh = use_device_mesh
        self.mesh_signal_capacity = mesh_signal_capacity
        self.profile_programs_every = profile_programs_every
        self.profile_ops = profile_ops
        self.device = device
        self._program_profiler = None
        self._step_count = 0
        self._init_kwargs = dict(
            scores_to_compute=(
                (["relative_perf_scores"] if calc_relative_scores else [])
                + (["individual_perf_scores"] if calc_individual_scores else [])
            ),
            report_time_interval=report_time_interval,
            profiling_interval=profiling_interval,
            store=store,
            use_kernel=use_kernel,
            max_signals=max_signals,
            device=device,
        )
        self._section = None
        self.last_report = None

    def _build_mesh_telemetry(self, ctx: LoopContext):
        """One telemetry row per rank over the default process group — the
        configuration ``Detector._generate_mesh_report`` scores with no per-rank
        store gather (summaries travel through the group's collectives)."""
        from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

        world = dist.get_world_size() if dist.is_initialized() else 1
        if ctx.world_size <= 1 or world != ctx.world_size:
            log.info(
                "use_device_mesh requested but the job is not one process per rank in "
                f"the default process group (group size {world}, world "
                f"{ctx.world_size}); falling back to the store summary path"
            )
            return None
        return MeshTelemetry(
            ctx.world_size,
            signal_names=tuple(f"c{i}" for i in range(self.mesh_signal_capacity)),
            group=dist.group.WORLD,
            device=self.device,
        )

    def on_train_start(self, ctx: LoopContext) -> None:
        device_telemetry = (
            self._build_mesh_telemetry(ctx) if self.use_device_mesh else None
        )
        Detector.initialize(
            rank=ctx.rank,
            world_size=ctx.world_size,
            device_telemetry=device_telemetry,
            **self._init_kwargs,
        )

    def on_step_start(self, ctx: LoopContext) -> None:
        if self.profile_programs_every:
            if self._program_profiler is None:
                from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler

                self._program_profiler = DeviceTimeProfiler(
                    collect_ops=self.profile_ops, device=self.device
                )
            if self._step_count % self.profile_programs_every == 0:
                self._program_profiler.start()
        self._section = Detector.detection_section(self.section_name)
        self._section.__enter__()

    def on_step_end(self, ctx: LoopContext) -> None:
        if self._section is not None:
            self._section.__exit__(None, None, None)
            self._section = None
        self._step_count += 1
        if self._program_profiler is not None and self._program_profiler.active:
            self._fold_profiler_window()
        report = Detector.generate_report_if_interval_elapsed()
        if report is not None:
            self._handle_report(ctx, report)

    def _fold_profiler_window(self) -> tuple[dict, dict]:
        """Close the open profiler window and feed its samples to the Detector.
        Returns the window's ``(program samples, op samples)``."""
        prof = self._program_profiler
        prof.stop()
        programs = prof.drain()
        Detector.record_program_samples(programs)
        ops = prof.drain_ops() if self.profile_ops else {}
        Detector.record_op_samples(ops)
        return programs, ops

    def _close_profiler_window(self) -> None:
        if self._program_profiler is not None and self._program_profiler.active:
            self._program_profiler.stop()

    def on_exception(self, ctx: LoopContext, exc: BaseException) -> None:
        # A step that dies mid-window must not leak the process-global profiler:
        # the restarted loop's next window would find it running and fail to start.
        self._close_profiler_window()

    def on_train_end(self, ctx: LoopContext) -> None:
        if self._section is not None:
            self._section.__exit__(None, None, None)
            self._section = None
        self._close_profiler_window()
        Detector.shutdown()

    # -- report handling ---------------------------------------------------

    def _handle_report(self, ctx: LoopContext, report) -> None:
        self.last_report = report
        flat = dict(report.perf_scores or {})
        if flat:
            best = max(flat, key=flat.get)
            worst = min(flat, key=flat.get)
            log.info(
                f"straggler report: best rank {best}={flat[best]:.3f} "
                f"worst rank {worst}={flat[worst]:.3f}"
            )
            if self.export_metrics:
                ctx.metrics["straggler/best_score"] = float(flat[best])
                ctx.metrics["straggler/worst_score"] = float(flat[worst])
        stragglers = report.identify_stragglers(
            perf_threshold=self.threshold, section_threshold=self.threshold
        )
        if stragglers.by_perf or stragglers.by_section:
            log.warning(f"stragglers detected: {stragglers}")
            if self.export_metrics:
                ctx.metrics["straggler/detected"] = stragglers
            if self.stop_if_detected:
                ctx.should_stop = True
        # The machine-readable twin of the log lines above, on the structured JSONL
        # stream ($TPU_RESILIENCY_EVENTS_FILE) both packages write to.
        record_event(
            "telemetry",
            "straggler_report",
            step=ctx.step,
            # String keys: json.dumps would coerce int keys anyway, so use the
            # on-disk schema everywhere — in-process sinks and JSONL readers
            # index the same way.
            perf_scores={str(k): float(v) for k, v in flat.items()},
            stragglers_by_perf=sorted(s.rank for s in stragglers.by_perf),
            stragglers_by_section={
                name: sorted(s.rank for s in ids)
                for name, ids in stragglers.by_section.items()
            },
        )
        if self.health_policy is not None:
            self.health_policy.observe(report)
