"""Telemetry scoring on the device: the straggler pipeline in PyTorch.

Port of ``tpu_resiliency/telemetry/scoring.py`` (single-program mode). Over a
``[ranks, signals]`` telemetry matrix it computes:

- the per-signal **relative score**: (min over ranks of the signal's median) / the
  rank's median, in (0, 1];
- the **individual score**: the rank's historical minimum median / current median;
- the per-rank **perf score**: the total-time-weighted mean of relative scores over
  the signals the rank observed;
- the **robust-z** of perf scores across ranks and an **EWMA** over report rounds;
- the **straggler mask**: perf below threshold or robust-z below -z_threshold.

Every function takes and returns tensors on one device and runs eagerly there.

Two modes share the pipeline, as in the reference:

- **single-program** (``group=None``): the ``[R, ...]`` matrix is on one device and
  the cross-rank reductions are plain axis-0 ops;
- **process-group** (``group=`` a ``torch.distributed`` process group): each process
  holds its own block of rows, of the same size on every process, and the two
  cross-rank reductions become collectives: the per-signal reference median is an
  ``all_reduce(MIN)`` (the reference's ``lax.pmin``), and ``robust_z`` all-gathers
  the per-rank perf vector (the reference's ``lax.all_gather``). The tensors must be
  on a device the group's backend serves (NCCL: the card; gloo: the CPU). This mode
  answers the JAX package's ``score_round_jit``, ``make_sharded_scorer`` and
  ``score_round_sharded``, which compile the pipeline over a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

EPS = 1e-12
MAD_SCALE = 1.4826  # makes MAD a consistent sigma estimator under normality
# Perf scores live in (0, 1]; when every healthy rank scores identically the MAD
# degenerates to ~0 and float jitter over EPS would z-flag the whole fleet. The
# floor says: deviations under ~3e-3 in score units are never outliers.
MAD_FLOOR = 1e-3
DEFAULT_THRESHOLD = 0.75
DEFAULT_Z_THRESHOLD = 3.0
DEFAULT_EWMA_ALPHA = 0.5


def _valid_slots(counts: torch.Tensor, w: int) -> torch.Tensor:
    pos = torch.arange(w, dtype=torch.int32, device=counts.device)
    return pos < counts[..., None]


def _take_or_nan(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``s[..., idx]`` per row, NaN where ``idx`` lies past the last axis, as
    ``jnp.take_along_axis`` fills an out-of-range index (``torch.gather`` raises)."""
    w = s.shape[-1]
    v = torch.gather(s, -1, idx.clamp(max=w - 1).long()[..., None])[..., 0]
    return torch.where(idx < w, v, float("nan"))


def masked_median(data: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, honoring per-row valid-sample counts.

    ``data``: f32 [..., W] windows; ``counts``: i32 [...] valid samples per window
    (0 gives +inf). Invalid slots sort to +inf; the median of ``n`` valid samples
    is the mean of elements ``(n-1)//2`` and ``n//2`` of the sorted prefix. A count
    of 2W or more puts an element past the window: NaN, as in the JAX package.
    """
    valid = _valid_slots(counts, data.shape[-1])
    padded = torch.where(valid, data, float("inf"))
    s = torch.sort(padded, dim=-1).values
    lo = _take_or_nan(s, (counts - 1).clamp(min=0) // 2)
    hi = _take_or_nan(s, counts.clamp(min=0) // 2)
    med = 0.5 * (lo + hi)
    return torch.where(counts > 0, med, float("inf"))


def masked_total(data: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis honoring valid counts (the per-signal time weight)."""
    valid = _valid_slots(counts, data.shape[-1])
    return torch.where(valid, data, 0.0).sum(dim=-1)


# ``all_gather_single`` is the newer name of ``all_gather_into_tensor``.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def check_group(group) -> None:
    """Raise unless ``group`` is ``None`` or a ``torch.distributed`` process group."""
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"group must be a torch.distributed process group, got {type(group)}")


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every process of ``group``, in group-rank order: ``[world * n,
    ...]`` from this process's ``x [n, ...]`` (the same ``n`` on every process)."""
    out = torch.empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_single(out, x.contiguous(), group=group)
    return out


def relative_scores(
    medians: torch.Tensor, valid: torch.Tensor, group=None
) -> torch.Tensor:
    """[R, S] relative scores vs the fastest rank per signal; over ``group`` the
    reference median is the minimum across every process's rows."""
    ref = torch.where(valid, medians, float("inf")).amin(dim=0, keepdim=True)
    if group is not None:
        dist.all_reduce(ref, op=dist.ReduceOp.MIN, group=group)
    scores = ref / medians.clamp(min=EPS)
    # Signals nobody measured have ref=inf; signals this rank didn't measure score 1.
    scores = torch.where(torch.isfinite(ref), scores, 1.0)
    return torch.where(valid, scores, 1.0).clamp(0.0, 1.0)


def individual_scores(
    medians: torch.Tensor, valid: torch.Tensor, historical_min: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-local scores vs the rank's own best-ever median. Returns (scores, new_min)."""
    new_min = torch.where(valid, torch.minimum(historical_min, medians), historical_min)
    scores = new_min / medians.clamp(min=EPS)
    return torch.where(valid, scores, 1.0).clamp(0.0, 1.0), new_min


def perf_scores(
    section_scores: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """[R] per-rank score: total-time-weighted mean over observed signals."""
    w = torch.where(valid, weights, 0.0)
    denom = w.sum(dim=1).clamp(min=EPS)
    return (section_scores * w).sum(dim=1) / denom


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements; for an even count the mean of the two middle values,
    as ``jnp.median`` gives it (``torch.median`` would return the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def robust_z(x: torch.Tensor, group=None) -> torch.Tensor:
    """Median/MAD z-score along the rank axis; over ``group`` the median and MAD
    are taken over every process's ranks (an all-gather of the perf vector)."""
    full = x if group is None else all_gather_rows(x, group)
    med = _median(full)
    mad = _median((full - med).abs())
    return (x - med) / (MAD_SCALE * mad).clamp(min=MAD_FLOOR)


@dataclasses.dataclass
class TelemetryScores:
    """Result of one scoring round."""

    section_scores: Any  # f32 [R, S] relative score per signal
    individual_section_scores: Any  # f32 [R, S] vs rank-historical best
    perf: Any  # f32 [R]   weighted per-rank score
    z: Any  # f32 [R]   robust-z of perf across ranks
    ewma: Any  # f32 [R]   smoothed perf score
    straggler: Any  # bool [R]
    historical_min: Any  # f32 [R, S] carried state


def score_round(
    data: Optional[torch.Tensor],
    counts: torch.Tensor,
    prev_ewma: torch.Tensor,
    historical_min: torch.Tensor,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    z_threshold: float = DEFAULT_Z_THRESHOLD,
    alpha: float = DEFAULT_EWMA_ALPHA,
    medians_and_weights: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    group=None,
) -> TelemetryScores:
    """The scoring pipeline over raw telemetry windows.

    ``data``: f32 [R, S, W] per-rank per-signal timing windows (may be ``None`` when
    ``medians_and_weights`` is given); ``counts``: i32 [R, S] valid samples per window;
    ``prev_ewma``: f32 [R] (start with ones); ``historical_min``: f32 [R, S] (start
    with +inf). ``medians_and_weights`` short-circuits the window reduction with
    precomputed ``(medians [R,S], weights [R,S])`` — the hook the kernel path uses.
    ``group`` scores over a process group: R is then this process's block of rows,
    and every output holds this process's rows.
    """
    check_group(group)
    if medians_and_weights is None:
        medians = masked_median(data, counts)
        weights = masked_total(data, counts)
    else:
        medians, weights = medians_and_weights
    valid = counts > 0
    section = relative_scores(medians, valid, group)
    indiv, new_min = individual_scores(medians, valid, historical_min)
    perf = perf_scores(section, weights, valid)
    z = robust_z(perf, group)
    ewma = alpha * perf + (1.0 - alpha) * prev_ewma
    straggler = (perf < threshold) | (z < -z_threshold)
    return TelemetryScores(
        section_scores=section,
        individual_section_scores=indiv,
        perf=perf,
        z=z,
        ewma=ewma,
        straggler=straggler,
        historical_min=new_min,
    )


def score_summary(
    medians: torch.Tensor,
    weights: torch.Tensor,
    counts: torch.Tensor,
    prev_ewma: torch.Tensor,
    historical_min: torch.Tensor,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    z_threshold: float = DEFAULT_Z_THRESHOLD,
    alpha: float = DEFAULT_EWMA_ALPHA,
    group=None,
) -> TelemetryScores:
    """Score precomputed per-(rank, signal) medians and weights (window reduction
    already done); ``group`` as in :func:`score_round`."""
    return score_round(
        None,
        counts,
        prev_ewma,
        historical_min,
        threshold=threshold,
        z_threshold=z_threshold,
        alpha=alpha,
        medians_and_weights=(medians, weights),
        group=group,
    )


_FIELDS = tuple(f.name for f in dataclasses.fields(TelemetryScores))


def scores_to_host(res: TelemetryScores) -> TelemetryScores:
    """The scores as numpy arrays, in ONE device-to-host copy: every field is
    flattened into one f32 buffer on the device first, so a report costs one
    transfer and one synchronisation, not one per array."""
    tensors = [getattr(res, name) for name in _FIELDS]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, offset = {}, 0
    for name, t in zip(_FIELDS, tensors):
        n = t.numel()
        arr = flat[offset : offset + n].reshape(tuple(t.shape))
        out[name] = arr.astype(bool) if t.dtype == torch.bool else arr
        offset += n
    return TelemetryScores(**out)


def gather_scores(res: TelemetryScores, group) -> TelemetryScores:
    """Every process's rows of ``res`` (a round scored over ``group``), in group-rank
    order, on this process's device: ONE all-gather of every field's rows packed
    into one f32 block, so each process can build the full report."""
    tensors = [getattr(res, name) for name in _FIELDS]
    local = tensors[0].shape[0]
    widths = [t.numel() // max(local, 1) for t in tensors]
    packed = torch.cat([t.reshape(local, w).to(torch.float32) for t, w in zip(tensors, widths)], 1)
    full = all_gather_rows(packed, group)
    out = {}
    for name, t, cols in zip(_FIELDS, tensors, full.split(widths, dim=1)):
        arr = cols.reshape(full.shape[0], *t.shape[1:])
        out[name] = arr != 0 if t.dtype == torch.bool else arr.to(t.dtype)
    return TelemetryScores(**out)


__all__ = [
    "DEFAULT_EWMA_ALPHA",
    "DEFAULT_THRESHOLD",
    "DEFAULT_Z_THRESHOLD",
    "TelemetryScores",
    "all_gather_rows",
    "check_group",
    "gather_scores",
    "individual_scores",
    "masked_median",
    "masked_total",
    "perf_scores",
    "relative_scores",
    "robust_z",
    "score_round",
    "score_summary",
    "scores_to_host",
]
