"""What a loop hands back to the harness after one run of a cell."""

from __future__ import annotations

import dataclasses

from benchmark.checks import Check


@dataclasses.dataclass
class Outcome:
    window_start: float  # wall clock at the measured window's start (time.time())
    end_to_end: dict[str, float]  # the cell's end-to-end metrics but set-up
    counters: dict  # counts and host-clock sums the per-layer readers take
    checks: list[Check]  # every number compared, with its limit
    attempted: int  # units of work in the window
    failed: int  # compared units found wrong
    memory_peak_bytes: int  # the device's allocation peak when the window closed
