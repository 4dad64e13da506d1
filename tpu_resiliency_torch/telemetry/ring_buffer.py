"""Fixed-capacity ring buffers for timing samples — host-side and device-resident.

Port of ``tpu_resiliency/telemetry/ring_buffer.py``. The host rings
(:class:`SignalRings`, :class:`RingView`, :class:`HostRingBuffer`) are the
reference's numpy path: its native collector (``tpu_resiliency._ringstats``) is not
ported, so ``native`` is always false here. :class:`DeviceRings` keeps its rings in
tensors on an explicit device and updates them in place: ``push_row`` writes one
column at ``cursor % capacity`` with ``index_copy_`` and advances counts and cursor
on the device, so a step never waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from tpu_resiliency_torch.platform.device import resolve_device

STAT_KEYS = ("count", "min", "max", "median", "avg", "std", "total")


class SignalRings:
    """``n_rings`` fixed-capacity rings in one numpy block, with per-ring stats.

    The host collector behind the straggler detector. Consumers hold
    :class:`RingView` handles (``.view(i)``) so per-signal call sites stay simple
    while storage stays pooled. ``native=True`` raises: the native collector of the
    JAX package is not ported.
    """

    def __init__(self, n_rings: int, capacity: int, native: Optional[bool] = None):
        if n_rings <= 0 or capacity <= 0:
            raise ValueError("n_rings and capacity must be positive")
        if native:
            raise RuntimeError("native rings are not ported; use the numpy rings")
        self.n_rings = n_rings
        self.capacity = capacity
        self._buf = np.zeros((n_rings, capacity), dtype=np.float64)
        self._next = np.zeros(n_rings, dtype=np.int64)
        self._count = np.zeros(n_rings, dtype=np.int64)

    @property
    def native(self) -> bool:
        return False

    def view(self, index: int) -> "RingView":
        if not 0 <= index < self.n_rings:
            raise IndexError(f"ring {index} out of range [0, {self.n_rings})")
        return RingView(self, index)

    # -- per-ring operations ------------------------------------------------

    def push(self, i: int, value: float) -> None:
        self._buf[i, self._next[i]] = value
        self._next[i] = (self._next[i] + 1) % self.capacity
        self._count[i] = min(self._count[i] + 1, self.capacity)

    def extend(self, i: int, values) -> None:
        for v in np.ascontiguousarray(values, dtype=np.float64).ravel():
            self.push(i, float(v))

    def count(self, i: int) -> int:
        return int(self._count[i])

    def linearize(self, i: int) -> np.ndarray:
        """Samples oldest→newest (reference ``CircularBuffer.linearize()``)."""
        n, head = int(self._count[i]), int(self._next[i])
        if n < self.capacity:
            return self._buf[i, :n].copy()
        return np.concatenate([self._buf[i, head:], self._buf[i, :head]])

    def stats(self, i: int) -> dict[str, float]:
        """One-pass summary: count/min/max/median/avg/std/total (reference
        ``computeStats``, ``CuptiProfiler.cpp:44-74``). Raises on an empty ring."""
        if self._count[i] == 0:
            raise ValueError("stats of an empty ring")
        arr = self.linearize(i)
        return {
            "count": int(arr.size),
            "min": float(arr.min()),
            "max": float(arr.max()),
            "median": float(np.median(arr)),
            "avg": float(arr.mean()),
            "std": float(arr.std()),
            "total": float(arr.sum()),
        }

    def reset(self, i: int) -> None:
        self._next[i] = 0
        self._count[i] = 0

    def reset_all(self) -> None:
        self._next[:] = 0
        self._count[:] = 0


class RingView:
    """One signal's handle into a :class:`SignalRings` pool."""

    __slots__ = ("_rings", "_i")

    def __init__(self, rings: SignalRings, index: int):
        self._rings = rings
        self._i = index

    @property
    def capacity(self) -> int:
        return self._rings.capacity

    @property
    def native(self) -> bool:
        return self._rings.native

    def push(self, value: float) -> None:
        self._rings.push(self._i, value)

    def extend(self, values) -> None:
        self._rings.extend(self._i, values)

    def __len__(self) -> int:
        return self._rings.count(self._i)

    def linearize(self) -> np.ndarray:
        return self._rings.linearize(self._i)

    def stats(self) -> dict[str, float]:
        return self._rings.stats(self._i)

    def reset(self) -> None:
        self._rings.reset(self._i)


class HostRingBuffer(RingView):
    """A standalone single ring (a pool of one) — the simple-case API."""

    def __init__(self, capacity: int, native: Optional[bool] = None):
        super().__init__(SignalRings(1, capacity, native=native), 0)


@dataclasses.dataclass
class DeviceRings:
    """Device-resident rings for ``n_signals`` timing streams.

    ``(data [n_signals, capacity], cursor [], counts [n_signals])`` on one device::

        rings = DeviceRings.create(n_signals=..., capacity=...)   # on the card
        ...
        rings.push_row(step_durations)   # in place, no host sync

    ``push_row`` writes one sample per signal (a step's timings for every signal at
    once) at a shared cursor that stays on the device. ``push_row`` and ``reset``
    update the tensors in place and return ``self`` (the JAX version returns a new
    pytree for donation).
    """

    data: Any  # f32 [n_signals, capacity]
    cursor: Any  # i64 []
    counts: Any  # i32 [n_signals]

    @staticmethod
    def create(n_signals: int, capacity: int, dtype=None, device=None) -> "DeviceRings":
        """Empty rings on ``device`` (``None`` means the CUDA card; raises without
        one)."""
        dev = resolve_device(device)
        return DeviceRings(
            data=torch.zeros((n_signals, capacity), dtype=dtype or torch.float32, device=dev),
            cursor=torch.zeros((), dtype=torch.int64, device=dev),
            counts=torch.zeros((n_signals,), dtype=torch.int32, device=dev),
        )

    def push_row(self, values) -> "DeviceRings":
        capacity = self.data.shape[1]
        values = torch.as_tensor(values, dtype=self.data.dtype, device=self.data.device)
        idx = torch.remainder(self.cursor, capacity).reshape(1)
        self.data.index_copy_(1, idx, values.reshape(-1, 1))
        self.counts.add_(1).clamp_(max=capacity)
        self.cursor.add_(1)
        return self

    def valid_mask(self) -> torch.Tensor:
        """[n_signals, capacity] bool — True where a real sample exists."""
        pos = torch.arange(self.data.shape[1], device=self.data.device)[None, :]
        return pos < self.counts[:, None]

    def reset(self) -> "DeviceRings":
        """Empty every ring; stale data stays and is masked out by the counts."""
        self.cursor.zero_()
        self.counts.zero_()
        return self
