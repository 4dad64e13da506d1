"""The numbers that decide ``correct``: each compared against a limit of its own.

A cell's limits are data, in ``benchmark/limits/<workload>.json``: for each number its
limit, and the two readings it was set between (the largest of the program's sound
runs, the smallest of the control's or of a fault's).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


def load_limits(workload: str) -> dict[str, float]:
    spec = json.loads((LIMITS_DIR / f"{workload}.json").read_text())
    return {name: float(entry["limit"]) for name, entry in spec["limits"].items()}


class Checks:
    """Collects the compared numbers of one run against the cell's limits. A number
    measured more than once keeps its worst reading."""

    def __init__(self, limits: dict[str, float]):
        self.limits = limits
        self.values: dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        value = float(value)
        old = self.values.get(name)
        if old is None or math.isnan(value) or value > old:
            self.values[name] = value

    def results(self) -> list[Check]:
        missing = sorted(set(self.limits) - set(self.values))
        if missing:
            raise RuntimeError(f"compared numbers never read: {missing}")
        return [Check(n, self.values[n], self.limits[n]) for n in self.limits]

