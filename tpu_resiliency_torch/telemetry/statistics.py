"""Summary-statistic selection for telemetry reports.

A copy of ``tpu_resiliency/telemetry/statistics.py``, which is JAX-free but reachable
only through a package ``__init__`` that imports JAX.

Analogue of the reference's ``straggler/statistics.py:19`` MIN/MAX/MED/AVG/STD/NUM enum.
"""

from __future__ import annotations

import enum

import numpy as np


class Statistic(enum.Enum):
    MIN = "min"
    MAX = "max"
    MED = "med"
    AVG = "avg"
    STD = "std"
    NUM = "num"


ALL_STATISTICS = tuple(Statistic)


def compute_stats(samples, stats=ALL_STATISTICS) -> dict[Statistic, float]:
    """Summary stats of a 1-D sample array (host-side; device path uses scoring.py)."""
    arr = np.asarray(samples, dtype=np.float64)
    out: dict[Statistic, float] = {}
    n = arr.size
    for s in stats:
        if s is Statistic.NUM:
            out[s] = float(n)
        elif n == 0:
            out[s] = float("nan")
        elif s is Statistic.MIN:
            out[s] = float(arr.min())
        elif s is Statistic.MAX:
            out[s] = float(arr.max())
        elif s is Statistic.MED:
            out[s] = float(np.median(arr))
        elif s is Statistic.AVG:
            out[s] = float(arr.mean())
        elif s is Statistic.STD:
            out[s] = float(arr.std(ddof=1)) if n > 1 else 0.0
    return out
