"""Bounded in-process time-series rings (the watchtower's TSDB).

Every signal the system serves today is either a live snapshot (``/metrics``,
``/storez``, ``/goodput``) or post-hoc forensics; nothing retains *history*,
so nothing can answer "is step time trending up?" or "is the SLO burning?".
This module is the smallest structure that can: a :class:`SeriesRing` is a
fixed-capacity ring of ``(ts, value)`` samples, and a :class:`SeriesStore`
keys rings by metric family + labels — a few hundred floats per family, never
a database. The alert engine (``telemetry/watchtower.py``) feeds rings off the
``observe_record`` bridge and evaluates rules over the window/quantile/EWMA
helpers below.

Determinism contract: rings are pure containers — append order in, append
order out, no wall-clock reads — so replaying the same record stream through
the same feed code reproduces ring contents (and therefore every rule
verdict) exactly. All helpers are pure functions over sample lists for the
same reason.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, List, Optional, Tuple

Sample = Tuple[float, float]


class SeriesRing:
    """Fixed-capacity ring of ``(ts, value)`` samples in append order.

    Appends are O(1): once full, the oldest sample is overwritten. Reads
    return copies (callers iterate outside the writer's lock).
    """

    __slots__ = ("capacity", "_buf", "_head", "_n")

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[Optional[Sample]] = [None] * self.capacity
        self._head = 0  # next write slot
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def observe(self, ts: float, value: float) -> None:
        self._buf[self._head] = (float(ts), float(value))
        self._head = (self._head + 1) % self.capacity
        if self._n < self.capacity:
            self._n += 1

    def samples(
        self, start: Optional[float] = None, end: Optional[float] = None
    ) -> List[Sample]:
        """All retained samples (append order), optionally windowed to
        ``start < ts <= end`` — the half-open window rule evaluation uses so
        a sample sits in exactly one adjacent window."""
        if self._n < self.capacity:
            out = [s for s in self._buf[: self._n]]
        else:
            out = self._buf[self._head:] + self._buf[: self._head]
        return [
            s for s in out
            if s is not None
            and (start is None or s[0] > start)
            and (end is None or s[0] <= end)
        ]

    def last(self) -> Optional[Sample]:
        if self._n == 0:
            return None
        return self._buf[(self._head - 1) % self.capacity]


class SeriesStore:
    """Rings keyed by ``(family, sorted labels)`` — the in-process TSDB.

    Thread-safe for concurrent feed/query (one lock; operations are tiny).
    """

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._rings: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(family: str, labels: Optional[dict]) -> tuple:
        return (family, tuple(sorted((labels or {}).items())))

    def series(self, family: str, **labels) -> SeriesRing:
        """The ring for one family+labels, created on first touch."""
        key = self._key(family, labels)
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = SeriesRing(self.capacity)
            return ring

    def observe(self, family: str, ts: float, value: float, **labels) -> None:
        self.series(family, **labels).observe(ts, value)

    def query(
        self,
        family: str,
        start: Optional[float] = None,
        end: Optional[float] = None,
        **labels,
    ) -> List[Sample]:
        """Windowed samples for one series; empty if the series never fed."""
        key = self._key(family, labels)
        with self._lock:
            ring = self._rings.get(key)
        return [] if ring is None else ring.samples(start=start, end=end)

    def families(self) -> List[tuple]:
        with self._lock:
            return sorted(self._rings)

    def sizes(self) -> dict:
        """``{"family{k=v,...}": n_samples}`` — the /alerts doc's ring census."""
        with self._lock:
            items = list(self._rings.items())
        out = {}
        for (family, labels), ring in items:
            tag = ",".join(f"{k}={v}" for k, v in labels)
            out[f"{family}{{{tag}}}" if tag else family] = len(ring)
        return out


# -- pure helpers over sample lists -----------------------------------------

def rate(samples: Iterable[Sample]) -> Optional[float]:
    """Per-second increase across a counter-style window.

    Counter resets (a value drop — restarted emitter) contribute the
    post-reset value, matching Prometheus ``rate()`` semantics.
    """
    samples = list(samples)
    if len(samples) < 2:
        return None
    t0, t1 = samples[0][0], samples[-1][0]
    if t1 <= t0:
        return None
    total, prev = 0.0, samples[0][1]
    for _, v in samples[1:]:
        total += (v - prev) if v >= prev else v
        prev = v
    return total / (t1 - t0)


def quantile_over_time(samples: Iterable[Sample], q: float) -> Optional[float]:
    """Linear-interpolated quantile of the window's values."""
    vals = sorted(v for _, v in samples)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    q = min(1.0, max(0.0, q))
    pos = q * (len(vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def mean_over_time(samples: Iterable[Sample]) -> Optional[float]:
    vals = [v for _, v in samples]
    if not vals:
        return None
    return sum(vals) / len(vals)


def ewma(samples: Iterable[Sample], alpha: float = 0.3) -> Optional[float]:
    """Exponentially-weighted moving average over the window, append order."""
    out = None
    for _, v in samples:
        out = v if out is None else out + alpha * (v - out)
    return out


def mad(samples: Iterable[Sample]) -> Optional[float]:
    """Median absolute deviation of the window's values (robust spread)."""
    vals = [v for _, v in samples]
    if not vals:
        return None
    med = quantile_over_time([(0.0, v) for v in vals], 0.5)
    dev = [(0.0, abs(v - med)) for v in vals]
    return quantile_over_time(dev, 0.5)


def robust_zscore(x: float, samples: Iterable[Sample]) -> Optional[float]:
    """``(x - median) / (1.4826 * MAD)`` — the step-anomaly rule's core.

    The 1.4826 factor makes MAD a consistent sigma estimate under normality.
    A zero-MAD window (a perfectly steady history — exactly the baseline a
    straggler spike must register against) floors the scale at 1% of the
    median's magnitude instead of going infinite; an all-zero window still
    returns None (no scale exists at all).
    """
    samples = list(samples)
    if len(samples) < 2:
        return None
    med = quantile_over_time(samples, 0.5)
    spread = mad(samples)
    if spread is None:
        return None
    if spread <= 0.0:
        spread = 0.01 * abs(med)
        if spread <= 0.0:
            return None
    return (x - med) / (1.4826 * spread)
