"""Report-interval estimation from observed step time.

A copy of ``tpu_resiliency/telemetry/interval_tracker.py``; the store stays
duck-typed (``set_add``, ``barrier``, ``set_get``).

Analogue of the reference's ``ReportIntervalTracker`` (``straggler/interval_tracker.py:44-84``):
measure the median step wall-time over the first N iterations, derive how many
iterations fit in ``report_time_interval`` seconds, and make all ranks agree by taking
the MAX across ranks (reference uses an all-reduce; here the merge goes through the
coordination store since it happens exactly once per job).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

ESTIMATION_ITERS = 16


class ReportIntervalTracker:
    def __init__(
        self,
        report_time_interval: float,
        store=None,
        world_size: int = 1,
        rank: int = 0,
        key: str = "telemetry/report_interval",
    ):
        self.report_time_interval = report_time_interval
        self.store = store
        self.world_size = world_size
        self.rank = rank
        self.key = key
        self.iteration = 0
        self.interval: Optional[int] = None
        self._step_times: list[float] = []
        self._last_ts: Optional[float] = None

    def _local_estimate(self) -> int:
        med = float(np.median(self._step_times)) if self._step_times else 1.0
        return max(1, round(self.report_time_interval / max(med, 1e-9)))

    def iter_increase(self) -> None:
        """Call once per training iteration until the interval locks in."""
        if self.interval is not None:
            self.iteration += 1
            return
        now = time.monotonic()
        if self._last_ts is not None:
            self._step_times.append(now - self._last_ts)
        self._last_ts = now
        self.iteration += 1
        if len(self._step_times) >= ESTIMATION_ITERS:
            est = self._local_estimate()
            if self.store is not None and self.world_size > 1:
                # All ranks must agree; merge by MAX like the reference's all-reduce.
                self.store.set_add(self.key, [est])
                self.store.barrier(f"{self.key}/sync", self.rank, self.world_size, 60.0)
                est = max(self.store.set_get(self.key))
            self.interval = est

    def is_interval_elapsed(self) -> bool:
        return self.interval is not None and self.iteration % self.interval == 0
