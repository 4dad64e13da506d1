"""Report objects and straggler identification over the scoring results.

Port of ``tpu_resiliency/telemetry/reporting.py``. ``StragglerId``, ``Stragglers``
and ``Report`` are plain host objects, copied as they are; ``ReportGenerator`` runs
the scoring pipeline of ``telemetry/scoring.py`` on the device and pulls only the
final score vectors to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu_resiliency_torch.ops.scoring_kernels import fused_median_weights
from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.telemetry import scoring


@dataclasses.dataclass(frozen=True)
class StragglerId:
    """One flagged rank."""

    rank: int
    score: float
    z: float = float("nan")
    host: Optional[str] = None

    def __str__(self) -> str:
        host = f" host={self.host}" if self.host else ""
        return f"rank={self.rank}{host} score={self.score:.3f} z={self.z:+.2f}"


@dataclasses.dataclass
class Stragglers:
    """Result of ``Report.identify_stragglers``."""

    by_perf: frozenset[StragglerId]
    by_section: dict[str, frozenset[StragglerId]]

    @property
    def any(self) -> bool:
        return bool(self.by_perf) or any(self.by_section.values())


@dataclasses.dataclass
class Report:
    """One scoring round's results, as seen by one rank.

    ``perf_scores`` / ``z_scores`` / ``ewma_scores`` cover every rank: the device
    pipeline always has the global matrix.
    """

    rank: int
    world_size: int
    iteration: int
    section_names: tuple[str, ...]
    # this rank's per-section scores
    relative_section_scores: dict[str, float]
    individual_section_scores: dict[str, float]
    # global per-rank columns (None when running local-only)
    perf_scores: Optional[dict[int, float]] = None
    z_scores: Optional[dict[int, float]] = None
    ewma_scores: Optional[dict[int, float]] = None
    # per-rank per-section relative scores, [R, S], optional global view
    global_section_scores: Optional[np.ndarray] = None
    rank_to_host: Optional[dict[int, str]] = None

    def identify_stragglers(
        self,
        perf_threshold: float = scoring.DEFAULT_THRESHOLD,
        section_threshold: float = scoring.DEFAULT_THRESHOLD,
        z_threshold: float = scoring.DEFAULT_Z_THRESHOLD,
    ) -> Stragglers:
        """Flag ranks whose perf score is below threshold OR whose robust-z is an
        outlier, and per-section slow ranks."""
        by_perf = set()
        if self.perf_scores:
            for r, s in self.perf_scores.items():
                z = (self.z_scores or {}).get(r, float("nan"))
                if s < perf_threshold or (not np.isnan(z) and z < -z_threshold):
                    by_perf.add(
                        StragglerId(r, s, z, (self.rank_to_host or {}).get(r))
                    )
        by_section: dict[str, frozenset] = {}
        if self.global_section_scores is not None:
            for j, name in enumerate(self.section_names):
                col = self.global_section_scores[:, j]
                flagged = {
                    StragglerId(
                        int(r),
                        float(col[r]),
                        host=(self.rank_to_host or {}).get(int(r)),
                    )
                    for r in np.nonzero(col < section_threshold)[0]
                }
                if flagged:
                    by_section[name] = frozenset(flagged)
        return Stragglers(by_perf=frozenset(by_perf), by_section=by_section)


def build_report(
    host: scoring.TelemetryScores,
    *,
    rank: int,
    world_size: int,
    iteration: int,
    section_names,
    rank_to_host: Optional[dict[int, str]],
) -> Report:
    """A :class:`Report` from host-side scores (the output of
    :func:`scoring.scores_to_host`)."""
    names = tuple(section_names)
    section = host.section_scores
    return Report(
        rank=rank,
        world_size=world_size,
        iteration=iteration,
        section_names=names,
        relative_section_scores={n: float(section[rank, j]) for j, n in enumerate(names)},
        individual_section_scores={
            n: float(host.individual_section_scores[rank, j]) for j, n in enumerate(names)
        },
        perf_scores={r: float(v) for r, v in enumerate(host.perf.tolist())},
        z_scores={r: float(v) for r, v in enumerate(host.z.tolist())},
        ewma_scores={r: float(v) for r, v in enumerate(host.ewma.tolist())},
        global_section_scores=section[:, : len(names)],
        rank_to_host=rank_to_host,
    )


class ReportGenerator:
    """Stateful scorer: carries EWMA and historical-min across rounds.

    Operates on the global telemetry matrix (``[R, S, W]`` windows or precomputed
    ``[R, S]`` medians+weights) on ``device`` (``None`` means the CUDA card) and
    emits :class:`Report` objects. ``use_kernel`` reduces the windows with
    :func:`fused_median_weights` in its auto mode (``loop`` up to the measured window
    cap, ``radix`` past it); otherwise the sort-based ``masked_median`` runs.
    """

    def __init__(
        self,
        world_size: int,
        max_signals: int,
        *,
        perf_threshold: float = scoring.DEFAULT_THRESHOLD,
        z_threshold: float = scoring.DEFAULT_Z_THRESHOLD,
        ewma_alpha: float = scoring.DEFAULT_EWMA_ALPHA,
        use_kernel: bool = False,
        rank_to_host: Optional[dict[int, str]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.world_size = world_size
        self.max_signals = max_signals
        self.perf_threshold = perf_threshold
        self.z_threshold = z_threshold
        self.ewma_alpha = ewma_alpha
        self.use_kernel = use_kernel
        self.rank_to_host = rank_to_host
        self.iteration = 0
        self.reset()

    def reset(self) -> None:
        self._ewma = torch.ones((self.world_size,), dtype=torch.float32, device=self.device)
        self._hist_min = torch.full(
            (self.world_size, self.max_signals), float("inf"), dtype=torch.float32,
            device=self.device,
        )

    def load_state(self, ewma, hist_min) -> None:
        """Start from a carried state, such as the JAX generator's: ``ewma
        [world_size]`` and ``hist_min [world_size, max_signals]`` as numpy arrays."""
        ewma = torch.tensor(np.asarray(ewma, dtype=np.float32), device=self.device)
        hist_min = torch.tensor(np.asarray(hist_min, dtype=np.float32), device=self.device)
        if ewma.shape != (self.world_size,) or hist_min.shape != (
            self.world_size, self.max_signals,
        ):
            raise ValueError(
                f"expected ewma [{self.world_size}] and hist_min "
                f"[{self.world_size}, {self.max_signals}], got {tuple(ewma.shape)} "
                f"and {tuple(hist_min.shape)}"
            )
        self._ewma = ewma
        self._hist_min = hist_min

    def _carry(self, res: scoring.TelemetryScores, s: int) -> None:
        self._ewma = res.ewma
        self._hist_min[:, :s] = res.historical_min  # in place: the carry is ours alone
        self.iteration += 1

    def _thresholds(self) -> dict:
        return dict(
            threshold=self.perf_threshold, z_threshold=self.z_threshold, alpha=self.ewma_alpha
        )

    def score(self, data: torch.Tensor, counts: torch.Tensor) -> scoring.TelemetryScores:
        """Run one scoring round on ``data [R,S,W]`` / ``counts [R,S]`` on the device."""
        s = data.shape[1]
        mw = fused_median_weights(data, counts) if self.use_kernel else None
        res = scoring.score_round(
            data, counts, self._ewma, self._hist_min[:, :s],
            medians_and_weights=mw, **self._thresholds(),
        )
        self._carry(res, s)
        return res

    def score_summary(self, medians, weights, counts) -> scoring.TelemetryScores:
        """Score precomputed per-(rank, signal) ``medians``/``weights`` summaries."""
        s = medians.shape[1]
        res = scoring.score_summary(
            medians, weights, counts, self._ewma, self._hist_min[:, :s], **self._thresholds(),
        )
        self._carry(res, s)
        return res

    def generate_summary_report(
        self, medians, weights, counts, section_names, *, rank: int = 0
    ) -> Report:
        res = self.score_summary(medians, weights, counts)
        return self._materialize(res, section_names, rank)

    def generate_report(self, data, counts, section_names, *, rank: int = 0) -> Report:
        """Score and materialize a :class:`Report` for ``rank``."""
        res = self.score(data, counts)
        return self._materialize(res, section_names, rank)

    def _materialize(self, res: scoring.TelemetryScores, section_names, rank: int) -> Report:
        return build_report(
            scoring.scores_to_host(res),
            rank=rank,
            world_size=self.world_size,
            iteration=self.iteration,
            section_names=section_names,
            rank_to_host=self.rank_to_host,
        )
