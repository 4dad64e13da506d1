"""Device-resident telemetry: the straggler ingestion and scoring hot loop.

Port of ``tpu_resiliency/telemetry/sharded.py``. Telemetry lives on
the card as a window-major ``[W, R, S]`` ring. Every step, :meth:`MeshTelemetry.push`
writes one ``[R, S]`` row in place at a cursor that stays on the device, so a step
never waits for the host. Every report, :meth:`MeshTelemetry.score` reads the ring
as ``[R, S, W]`` (a permuted view, no copy), reduces each window with a Hopper
kernel (``loop`` up to the measured window cap, ``radix`` past it) or the sort-based
path, and runs the scoring pipeline.
:meth:`MeshTelemetry.materialize` then makes the one device-to-host copy of the
report.

Usage in a train loop::

    mt = MeshTelemetry(n_ranks=R, signal_names=("step", "ckpt"))
    state = mt.init_state()
    for step in ...:
        mt.push(state, torch.stack([step_ms, ckpt_ms], -1))  # [R, S] on the card
        if step % interval == 0:
            state, report = mt.generate_report(state)

Over a process group (``group=``, the JAX package's ``mesh``/``axis``), each process
holds its own block of ``n_ranks / world`` rows on its device: it pushes its own rows,
the scoring round's cross-rank reductions are collectives (``scoring.score_round``),
and :meth:`MeshTelemetry.materialize` all-gathers the score rows before its one
device-to-host copy, so every process builds the full report. The summary path
(:meth:`MeshTelemetry.score_local_summary`, :meth:`MeshTelemetry.report_from_summary`)
scores per-rank ``[median, total, count]`` rows fed process-locally — the ``Detector``
report with no per-rank summary in the store.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from tpu_resiliency_torch.ops.scoring_kernels import (
    auto_mode,
    fused_median_weights,
    kernel_supported,
)
from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.telemetry import scoring
from tpu_resiliency_torch.telemetry.reporting import Report, build_report

DEFAULT_WINDOW = 32


def select_kernel_mode(
    window: int, signals: int, use_kernel: Optional[bool], device
) -> Optional[str]:
    """The window reduction a scorer runs: a kernel mode, or ``None`` for the sort path.

    ``use_kernel=None`` picks :func:`auto_mode` on a CUDA device when
    :func:`kernel_supported` admits the window (``loop`` up to the cap; ``radix`` past
    it while radix auto-selection is on), and the sort path otherwise.
    ``use_kernel=True`` runs :func:`auto_mode` wherever its kernel takes the window,
    as the JAX package's ``use_pallas=True`` runs its auto mode, and raises elsewhere.
    """
    if use_kernel is None:
        if torch.device(device).type != "cuda" or not kernel_supported(window, signals):
            return None
        return auto_mode(window)
    if not use_kernel:
        return None
    mode = auto_mode(window)
    if not kernel_supported(window, signals, mode=mode):
        raise ValueError(
            f"the {mode} kernel does not take window={window} with {signals} "
            f"signals; pass use_kernel=False"
        )
    return mode


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
    """Owner of the telemetry state's push and score programs.

    ``device=None`` means the CUDA card (raises when there is none). The window
    reduction is chosen once here by :func:`select_kernel_mode`, exposed as
    ``kernel_mode`` (``None`` for the sort path) and ``use_kernel``, and never changes.
    ``group``: a ``torch.distributed`` process group over which the ``n_ranks`` rows
    are split, ``local_ranks = n_ranks / world`` rows per process in group-rank
    order (``n_ranks`` must divide over the group's size); ``None`` keeps every row
    on this device.
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
        group=None,
        device=None,
    ):
        self.device = resolve_device(device)
        scoring.check_group(group)
        self.group = group
        self.n_ranks = int(n_ranks)
        world = 1 if group is None else dist.get_world_size(group)
        if self.n_ranks % world:
            raise ValueError(
                f"n_ranks={self.n_ranks} must divide over the group's size {world}"
            )
        self.local_ranks = self.n_ranks // world
        self.signal_names = tuple(signal_names)
        self.n_signals = len(self.signal_names)
        self.window = int(window)
        self.threshold = threshold
        self.z_threshold = z_threshold
        self.ewma_alpha = ewma_alpha
        self.rank_to_host = rank_to_host
        self.iteration = 0
        self.kernel_mode = select_kernel_mode(
            self.window, self.n_signals, use_kernel, self.device
        )
        self.use_kernel = self.kernel_mode is not None
        self._summary_state = None  # (ewma [L], hist_min [L, S]) of the summary path

    # -- state lifecycle ---------------------------------------------------

    def init_state(self) -> TelemetryState:
        """This process's state: its ``local_ranks`` rows."""
        r, s, w = self.local_ranks, self.n_signals, self.window
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
        """Append one ``[L, S]`` sample row (one measurement per local rank per
        signal; L = R without a group).

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
        mw = (
            fused_median_weights(data_rsw, state.counts, mode=self.kernel_mode)
            if self.use_kernel
            else None
        )
        scores = scoring.score_round(
            data_rsw,
            state.counts,
            state.ewma,
            state.hist_min,
            threshold=self.threshold,
            z_threshold=self.z_threshold,
            alpha=self.ewma_alpha,
            medians_and_weights=mw,
            group=self.group,
        )
        new_state = TelemetryState(
            data=state.data,
            counts=torch.zeros_like(state.counts),
            cursor=torch.zeros_like(state.cursor),
            ewma=scores.ewma,
            hist_min=scores.historical_min,
        )
        return new_state, scores

    # -- summary path ------------------------------------------------------

    def score_local_summary(self, medians, weights, counts) -> scoring.TelemetryScores:
        """Score per-rank summaries fed process-locally: this process's ``[L, S]``
        median / weight / count rows (numpy or tensors). Over a group, the
        cross-rank reductions are the round's collectives, and no summary passes
        through a store. The EWMA and historical minimum of this path are carried
        here, on the local rows. Returns the local rows' scores, on the device."""
        dev, shape = self.device, (self.local_ranks, self.n_signals)

        def put(x, dtype):
            t = torch.as_tensor(x, dtype=dtype, device=dev)
            if tuple(t.shape) != shape:
                raise ValueError(f"expected local summary rows {shape}, got {tuple(t.shape)}")
            return t

        med, wgt, cnt = put(medians, torch.float32), put(weights, torch.float32), put(
            counts, torch.int32)
        if self._summary_state is None:
            self._summary_state = (
                torch.ones((self.local_ranks,), dtype=torch.float32, device=dev),
                torch.full(shape, float("inf"), dtype=torch.float32, device=dev),
            )
        ewma, hist_min = self._summary_state
        scores = scoring.score_summary(
            med, wgt, cnt, ewma, hist_min, threshold=self.threshold,
            z_threshold=self.z_threshold, alpha=self.ewma_alpha, group=self.group,
        )
        self._summary_state = (scores.ewma, scores.historical_min)
        self.iteration += 1
        return scores

    def report_from_summary(
        self, medians, weights, counts, *, rank: int = 0,
        signal_names: Optional[Sequence[str]] = None,
    ) -> Report:
        """One summary round: score the process-local rows, build the Report.

        ``signal_names`` overrides the construction-time names (the Detector passes
        the agreed column list, which can be shorter than this object's column
        capacity — the tail columns carry counts 0 and score 1.0)."""
        scores = self.score_local_summary(medians, weights, counts)
        return self.materialize(scores, rank=rank, signal_names=signal_names)

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
        """The :class:`Report` of a round, seen by ``rank``: over a group, the score
        rows of every process are all-gathered first (one collective), then copied
        to the host once."""
        if self.group is not None:
            scores = scoring.gather_scores(scores, self.group)
        return build_report(
            scoring.scores_to_host(scores),
            rank=rank,
            world_size=self.n_ranks,
            iteration=self.iteration,
            section_names=signal_names if signal_names is not None else self.signal_names,
            rank_to_host=self.rank_to_host,
        )
