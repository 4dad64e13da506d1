"""Device-resident telemetry: the straggler ingestion and scoring hot loop.

Port of ``tpu_resiliency/telemetry/sharded.py`` on one device. Telemetry lives on
the card as a window-major ``[W, R, S]`` ring. Every step, :meth:`MeshTelemetry.push`
writes one ``[R, S]`` row in place at a cursor that stays on the device, so a step
never waits for the host. Every report, :meth:`MeshTelemetry.score` reads the ring
as ``[R, S, W]`` (a permuted view, no copy), reduces each window with the Hopper
kernel (or the sort-based path), and runs the scoring pipeline.
:meth:`MeshTelemetry.materialize` then makes the one device-to-host copy of the
report.

Usage in a train loop::

    mt = MeshTelemetry(n_ranks=R, signal_names=("step", "ckpt"))
    state = mt.init_state()
    for step in ...:
        mt.push(state, torch.stack([step_ms, ckpt_ms], -1))  # [R, S] on the card
        if step % interval == 0:
            state, report = mt.generate_report(state)

Sharding the rank axis over a process group (``mesh``/``axis`` in the JAX package)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from tpu_resiliency_torch.ops.scoring_kernels import fused_median_weights, kernel_supported
from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.telemetry import scoring
from tpu_resiliency_torch.telemetry.reporting import Report, build_report

DEFAULT_WINDOW = 32


@dataclasses.dataclass
class TelemetryState:
    """The device-resident carry: rings and scoring state.

    The ring is window-major ``[W, R, S]``: one push writes the contiguous ``[R, S]``
    slab at ``cursor % W``. The scorer reads it as ``[R, S, W]`` through a permuted
    view; the kernel takes the strides, so no transpose is materialized."""

    data: Any  # f32 [W, R, S] timing windows, window-major
    counts: Any  # i32 [R, S] valid samples per window
    cursor: Any  # i64 [] ring write position (ranks advance in lockstep)
    ewma: Any  # f32 [R] smoothed perf score, carried across reports
    hist_min: Any  # f32 [R, S] rank-historical best medians


class MeshTelemetry:
    """Owner of the telemetry state's push and score programs on one device.

    ``device=None`` means the CUDA card (raises when there is none). ``use_kernel=None``
    picks the Hopper kernel on CUDA whenever :func:`kernel_supported` admits the
    window; the choice is made once here, exposed as ``use_kernel``, and never changes.
    """

    def __init__(
        self,
        n_ranks: int,
        *,
        signal_names: Sequence[str] = ("step",),
        window: int = DEFAULT_WINDOW,
        threshold: float = scoring.DEFAULT_THRESHOLD,
        z_threshold: float = scoring.DEFAULT_Z_THRESHOLD,
        ewma_alpha: float = scoring.DEFAULT_EWMA_ALPHA,
        rank_to_host: Optional[dict[int, str]] = None,
        use_kernel: Optional[bool] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.n_ranks = int(n_ranks)
        self.signal_names = tuple(signal_names)
        self.n_signals = len(self.signal_names)
        self.window = int(window)
        self.threshold = threshold
        self.z_threshold = z_threshold
        self.ewma_alpha = ewma_alpha
        self.rank_to_host = rank_to_host
        self.iteration = 0
        supported = kernel_supported(self.window, self.n_signals)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda" and supported
        elif use_kernel and not supported:
            raise ValueError(
                f"the kernel does not take window={self.window} with "
                f"{self.n_signals} signals; pass use_kernel=False"
            )
        self.use_kernel = bool(use_kernel)

    # -- state lifecycle ---------------------------------------------------

    def init_state(self) -> TelemetryState:
        r, s, w = self.n_ranks, self.n_signals, self.window
        dev = self.device
        return TelemetryState(
            data=torch.zeros((w, r, s), dtype=torch.float32, device=dev),
            counts=torch.zeros((r, s), dtype=torch.int32, device=dev),
            cursor=torch.zeros((), dtype=torch.int64, device=dev),
            ewma=torch.ones((r,), dtype=torch.float32, device=dev),
            hist_min=torch.full((r, s), float("inf"), dtype=torch.float32, device=dev),
        )

    # -- ingestion ---------------------------------------------------------

    def push(self, state: TelemetryState, values) -> TelemetryState:
        """Append one ``[R, S]`` sample row (one measurement per rank per signal).

        Updates ``state`` in place and returns it (the JAX version donates the carry
        and returns a new one): the row goes into the ring at ``cursor % W`` with
        ``index_copy_``, counts and cursor advance on the device. Nothing here waits
        for the host.
        """
        w = state.data.shape[0]
        values = torch.as_tensor(values, dtype=state.data.dtype, device=state.data.device)
        idx = torch.remainder(state.cursor, w).reshape(1)
        state.data.index_copy_(0, idx, values.reshape(1, *state.data.shape[1:]))
        state.counts.add_(1).clamp_(max=w)
        state.cursor.add_(1)
        return state

    # -- scoring -----------------------------------------------------------

    def score(self, state: TelemetryState):
        """One report round: returns ``(new_state, TelemetryScores)`` with the rings
        reset (counts and cursor zero; stale samples are masked by the counts) and
        EWMA / historical minimum carried. Every output stays on the device."""
        self.iteration += 1
        data_rsw = state.data.permute(1, 2, 0)
        mw = fused_median_weights(data_rsw, state.counts) if self.use_kernel else None
        scores = scoring.score_round(
            data_rsw,
            state.counts,
            state.ewma,
            state.hist_min,
            threshold=self.threshold,
            z_threshold=self.z_threshold,
            alpha=self.ewma_alpha,
            medians_and_weights=mw,
        )
        new_state = TelemetryState(
            data=state.data,
            counts=torch.zeros_like(state.counts),
            cursor=torch.zeros_like(state.cursor),
            ewma=scores.ewma,
            hist_min=scores.historical_min,
        )
        return new_state, scores

    # -- report materialization -------------------------------------------

    def generate_report(self, state: TelemetryState, *, rank: int = 0):
        """Score and build a host-side :class:`Report` (the single device-to-host
        copy). Returns ``(new_state, report)``."""
        new_state, scores = self.score(state)
        return new_state, self.materialize(scores, rank=rank)

    def materialize(
        self,
        scores: scoring.TelemetryScores,
        *,
        rank: int = 0,
        signal_names: Optional[Sequence[str]] = None,
    ) -> Report:
        return build_report(
            scoring.scores_to_host(scores),
            rank=rank,
            world_size=self.n_ranks,
            iteration=self.iteration,
            section_names=signal_names if signal_names is not None else self.signal_names,
            rank_to_host=self.rank_to_host,
        )
