"""Process-global last-known-location beacon: where IS this rank right now?

The first question of every hang postmortem — "where was the job stuck?" —
is unanswerable from a heartbeat gap alone. This module keeps one cheap,
thread-safe record of the process's current location in the training
topology, updated by the layers that already know it:

- **section**: the monitor client's ``start_section``/``end_section``
  (``watchdog/monitor_client.py``) — setup / step / checkpointing.
- **step**: the in-process wrapper's ``iteration_start``
  (``inprocess/wrap.py``) and any loop that calls :func:`note_step`.
- **barrier**: the store client's blocking ``barrier_join``
  (``platform/store.py``) — the collective tag a rank is waiting in.

The beacon rides every ``HeartbeatMsg``/``SectionMsg`` to the rank monitor
(:meth:`snapshot` is the wire payload), so at detection time the watchdog can
say *"heartbeat gap exceeded 45s; last seen in section=step
barrier=rdzv/round-3 for 612s"* instead of just "heartbeat gap exceeded".

Timestamps are ``time.monotonic()``. On Linux ``CLOCK_MONOTONIC`` is
system-wide, so the monitor process on the same host can age a beacon
against its own clock; cross-host consumers must use the ``*_age_s`` fields
computed at send time and never compare raw stamps.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional


class LocationBeacon:
    """Thread-safe last-known-location record (one per process)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: LIFO of (name, entered_at) — sections nest (setup > step)
        self._sections: list[tuple[str, float]] = []
        self._step: Optional[int] = None
        self._step_at: float = 0.0
        #: LIFO of (tag, entered_at) — barrier joins can nest through retries
        self._barriers: list[tuple[str, float]] = []

    # -- writers -----------------------------------------------------------

    def enter_section(self, name: str) -> None:
        with self._lock:
            self._sections.append((str(name), time.monotonic()))

    def exit_section(self, name: Optional[str] = None) -> None:
        """Pop ``name`` (innermost match) or, with ``None``, everything."""
        with self._lock:
            if name is None:
                self._sections.clear()
                return
            for i in range(len(self._sections) - 1, -1, -1):
                if self._sections[i][0] == name:
                    del self._sections[i]
                    return

    def note_step(self, iteration: int) -> None:
        with self._lock:
            self._step = int(iteration)
            self._step_at = time.monotonic()

    def enter_barrier(self, tag: str) -> None:
        with self._lock:
            self._barriers.append((str(tag), time.monotonic()))

    def exit_barrier(self, tag: Optional[str] = None) -> None:
        with self._lock:
            if tag is None:
                self._barriers.clear()
                return
            for i in range(len(self._barriers) - 1, -1, -1):
                if self._barriers[i][0] == tag:
                    del self._barriers[i]
                    return

    @contextmanager
    def barrier(self, tag: str):
        self.enter_barrier(tag)
        try:
            yield
        finally:
            self.exit_barrier(tag)

    def reset(self) -> None:
        with self._lock:
            self._sections.clear()
            self._barriers.clear()
            self._step = None
            self._step_at = 0.0

    # -- the wire payload --------------------------------------------------

    def snapshot(self) -> dict:
        """The beacon payload heartbeats/sections carry to the monitor.

        ``entered_at`` is the monotonic instant the process entered its
        *current* (most blocking-relevant) location: the innermost open
        barrier when one exists, else the innermost section, else the last
        step marker. The per-field ``*_age_s`` values are computed here so a
        consumer on another clock domain still gets usable ages.
        """
        now = time.monotonic()
        with self._lock:
            section = self._sections[-1] if self._sections else None
            barrier = self._barriers[-1] if self._barriers else None
            step, step_at = self._step, self._step_at
        out: dict = {"v": 1}
        entered = None
        if step is not None:
            out["step"] = step
            out["step_age_s"] = round(max(0.0, now - step_at), 3)
            entered = step_at
        if section is not None:
            out["section"] = section[0]
            out["section_age_s"] = round(max(0.0, now - section[1]), 3)
            entered = section[1]
        if barrier is not None:
            out["barrier"] = barrier[0]
            out["barrier_age_s"] = round(max(0.0, now - barrier[1]), 3)
            entered = barrier[1]
        if entered is not None:
            out["entered_at"] = entered
        return out


#: the process beacon — importers share one so every layer's writes compose
_beacon = LocationBeacon()


def get_beacon() -> LocationBeacon:
    return _beacon


def snapshot() -> dict:
    return _beacon.snapshot()


def note_step(iteration: int) -> None:
    _beacon.note_step(iteration)


def enter_section(name: str) -> None:
    _beacon.enter_section(name)


def exit_section(name: Optional[str] = None) -> None:
    _beacon.exit_section(name)


def barrier(tag: str):
    """Context manager tagging the active barrier/collective."""
    return _beacon.barrier(tag)


def describe(loc: Optional[dict], age_s: Optional[float] = None) -> str:
    """One human fragment from a beacon payload: ``section=step
    barrier=rdzv/round-3 for 612s`` (empty string for no payload). ``age_s``
    overrides the payload's own age (a consumer that knows how long ago the
    beacon was *received* passes beacon-age + staleness)."""
    if not isinstance(loc, dict):
        return ""
    parts = []
    if loc.get("section") is not None:
        parts.append(f"section={loc['section']}")
    if loc.get("step") is not None:
        parts.append(f"step={loc['step']}")
    if loc.get("barrier") is not None:
        parts.append(f"barrier={loc['barrier']}")
    if not parts:
        return ""
    if age_s is None:
        for key in ("barrier_age_s", "section_age_s", "step_age_s"):
            if isinstance(loc.get(key), (int, float)):
                age_s = loc[key]
                break
    if isinstance(age_s, (int, float)):
        parts.append(f"for {age_s:.0f}s")
    return " ".join(parts)
