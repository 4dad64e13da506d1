"""Auto-calibration of heartbeat and section timeouts from observed behavior.

Analogue of the reference's ``TimeoutsCalc`` (``fault_tolerance/timeouts_calc.py``):
track the max observed initial/subsequent heartbeat gap and per-section durations,
cross-rank all-reduce MAX, multiply by a safety factor, and EMA-merge with previously
calculated values (``timeouts_calc.py:74-91,146-271``). The cross-rank merge goes
through the coordination store (calibration is rare) instead of a torch collective.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from tpu_resiliency_torch.exceptions import FaultToleranceError
from tpu_resiliency_torch.watchdog.data import HeartbeatTimeouts, SectionTimeouts

MERGE_WEIGHT = 0.5  # EMA weight for new measurements vs previous calculated values


@dataclasses.dataclass
class TimeoutsCalc:
    safety_factor: float = 5.0
    start_time: Optional[float] = None
    last_hb_time: Optional[float] = None
    initial_max_gap: float = 0.0
    subsequent_max_gap: float = 0.0
    hb_count: int = 0
    # sections
    section_max_elapsed: dict[str, float] = dataclasses.field(default_factory=dict)
    section_open_since: dict[str, float] = dataclasses.field(default_factory=dict)
    out_of_section_max: float = 0.0
    last_section_close: Optional[float] = None
    # Local collective-round counter: every rank calls synchronize_all the same number
    # of times, so a local counter keys the round namespace without a store read (a
    # store-read epoch races: a fast rank can re-enter before rank 0 bumps it).
    sync_epoch: int = 0

    def _now(self) -> float:
        return time.monotonic()

    def reset(self) -> None:
        self.start_time = self._now()
        self.last_hb_time = None
        self.hb_count = 0

    # -- heartbeat tracking ------------------------------------------------

    def update_on_heartbeat(self, hb_time: Optional[float] = None) -> None:
        now = self._now() if hb_time is None else hb_time
        if self.start_time is None:
            self.start_time = now
        if self.last_hb_time is None:
            self.initial_max_gap = max(self.initial_max_gap, now - self.start_time)
        else:
            self.subsequent_max_gap = max(self.subsequent_max_gap, now - self.last_hb_time)
        self.last_hb_time = now
        self.hb_count += 1

    @property
    def can_get_hb_timeouts(self) -> bool:
        return self.hb_count >= 2

    # -- section tracking --------------------------------------------------

    def update_on_section_open(self, name: str, ts: Optional[float] = None) -> None:
        now = self._now() if ts is None else ts
        if name in self.section_open_since:
            raise FaultToleranceError(f"section {name!r} already open")
        if self.last_section_close is not None and not self.section_open_since:
            self.out_of_section_max = max(self.out_of_section_max, now - self.last_section_close)
        self.section_open_since[name] = now

    def update_on_section_close(self, name: str, ts: Optional[float] = None) -> None:
        now = self._now() if ts is None else ts
        opened = self.section_open_since.pop(name, None)
        if opened is None:
            raise FaultToleranceError(f"section {name!r} is not open")
        self.section_max_elapsed[name] = max(
            self.section_max_elapsed.get(name, 0.0), now - opened
        )
        if not self.section_open_since:
            self.last_section_close = now

    # -- cross-rank merge + final timeouts ---------------------------------

    def synchronize_all(self, store, rank: int, world_size: int, key: str = "ft/timeouts") -> None:
        """All-reduce MAX of every tracked statistic across ranks via the store
        (reference ``timeouts_calc.py:74-91``)."""
        if world_size <= 1 or store is None:
            return
        ns = f"{key}/{self.sync_epoch}"
        self.sync_epoch += 1
        store.set(f"{ns}/rank/{rank}", self._stats())
        # Fixed barrier names: the server's generation-counted reentrant barriers make
        # them reusable across epochs without leaking per-epoch barrier state.
        store.barrier(f"{key}/sync", rank, world_size, 300.0)
        merged = [store.get(f"{ns}/rank/{r}", timeout=60.0) for r in range(world_size)]
        self._merge_max(merged)
        store.barrier(f"{key}/done", rank, world_size, 300.0)
        if rank == 0:
            for r in range(world_size):
                store.delete(f"{ns}/rank/{r}")

    def _stats(self) -> dict:
        return {
            "initial_max_gap": self.initial_max_gap,
            "subsequent_max_gap": self.subsequent_max_gap,
            "section_max_elapsed": dict(self.section_max_elapsed),
            "out_of_section_max": self.out_of_section_max,
        }

    def _merge_max(self, stats_list: list[dict]) -> None:
        for st in stats_list:
            self.initial_max_gap = max(self.initial_max_gap, st["initial_max_gap"])
            self.subsequent_max_gap = max(self.subsequent_max_gap, st["subsequent_max_gap"])
            for name, v in st["section_max_elapsed"].items():
                self.section_max_elapsed[name] = max(self.section_max_elapsed.get(name, 0.0), v)
            self.out_of_section_max = max(self.out_of_section_max, st["out_of_section_max"])

    def get_hb_timeouts(
        self, previous: Optional[HeartbeatTimeouts] = None
    ) -> HeartbeatTimeouts:
        """safety_factor × max gap, EMA-merged with previous calculated values
        (reference ``timeouts_calc.py:146-271``)."""
        if not self.can_get_hb_timeouts:
            raise FaultToleranceError("need ≥2 heartbeats to calculate timeouts")
        initial = self.safety_factor * max(self.initial_max_gap, self.subsequent_max_gap)
        subsequent = self.safety_factor * self.subsequent_max_gap
        if previous is not None and previous.calculated and previous.are_valid:
            initial = MERGE_WEIGHT * initial + (1 - MERGE_WEIGHT) * previous.initial
            subsequent = MERGE_WEIGHT * subsequent + (1 - MERGE_WEIGHT) * previous.subsequent
        return HeartbeatTimeouts(initial=initial, subsequent=subsequent, calculated=True)

    def get_section_timeouts(
        self, previous: Optional[SectionTimeouts] = None
    ) -> SectionTimeouts:
        section = {
            name: self.safety_factor * v for name, v in self.section_max_elapsed.items()
        }
        oos = self.safety_factor * self.out_of_section_max if self.out_of_section_max else None
        if previous is not None:
            for name in previous.calculated_sections:
                if name in section and previous.section.get(name) is not None:
                    section[name] = (
                        MERGE_WEIGHT * section[name]
                        + (1 - MERGE_WEIGHT) * previous.section[name]
                    )
            if (
                oos is not None
                and previous.calculated_out_of_section
                and previous.out_of_section is not None
            ):
                oos = MERGE_WEIGHT * oos + (1 - MERGE_WEIGHT) * previous.out_of_section
        return SectionTimeouts(
            section=section,
            out_of_section=oos,
            calculated_sections=frozenset(section),
            calculated_out_of_section=oos is not None,
        )
