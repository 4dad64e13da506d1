"""The plain reference of the straggler scorer's round: the EWMA + robust-z scoring
of every rank's medians and totals, as the straggler detector describes it.

Plain PyTorch, written from that description and independent of the program:

- relative score of a signal: the fastest rank's median over this rank's median;
- individual score: the rank's best median so far over its current median;
- perf score: the relative scores' mean weighted by each signal's total time;
- robust z of the perf scores across ranks: ``(x - median) / max(mad_scale * MAD,
  mad_floor)``; EWMA ``alpha * perf + (1 - alpha) * previous``;
- a rank is flagged when its perf score is under ``threshold`` or its z under
  ``-z_threshold``.

The round runs in float64.
"""

from __future__ import annotations

import dataclasses

import torch


def median_all(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


@dataclasses.dataclass
class Round:
    section: torch.Tensor  # [R, S]
    individual: torch.Tensor  # [R, S]
    perf: torch.Tensor  # [R]
    z: torch.Tensor  # [R]
    ewma: torch.Tensor  # [R]
    flagged: torch.Tensor  # bool [R]
    hist_min: torch.Tensor  # [R, S]


class Scorer:
    """The carried state (EWMA, best medians) and one round per report."""

    def __init__(self, config: dict, ranks: int, signals: int, device,
                 dtype=torch.float64):
        self.cfg = config
        self.dtype = dtype
        self.ewma = torch.ones(ranks, dtype=dtype, device=device)
        self.hist_min = torch.full((ranks, signals), float("inf"), dtype=dtype,
                                   device=device)

    def round(self, medians: torch.Tensor, totals: torch.Tensor) -> Round:
        c, dt = self.cfg, self.dtype
        med, tot = medians.to(dt), totals.to(dt)
        fastest = med.min(dim=0, keepdim=True).values
        section = (fastest / med).clamp(0.0, 1.0)
        hist_min = torch.minimum(self.hist_min, med)
        individual = (hist_min / med).clamp(0.0, 1.0)
        perf = (section * tot).sum(dim=1) / tot.sum(dim=1)
        center = median_all(perf)
        mad = median_all((perf - center).abs())
        scale = torch.clamp(c["mad_scale"] * mad, min=c["mad_floor"])
        z = (perf - center) / scale
        alpha = c["ewma_alpha"]
        ewma = alpha * perf + (1.0 - alpha) * self.ewma
        flagged = (perf < c["threshold"]) | (z < -c["z_threshold"])
        self.ewma, self.hist_min = ewma, hist_min
        return Round(section, individual, perf, z, ewma, flagged, hist_min)
