"""Distributed-consistent section/signal name → column-index mapping.

A copy of ``tpu_resiliency/telemetry/name_registry.py``; the store stays duck-typed
(``set_add``, ``set_get``).

The analogue of the reference's ``NameMapper`` (``straggler/name_mapper.py:56-81``),
which lazily all-gathers names so every rank agrees on int IDs. TPU-first redesign:
signal columns live in a fixed-capacity device matrix, and cross-rank agreement is
reached through the coordination store at report boundaries (rare, host-side) instead
of collectives — IDs are assigned by globally sorted name order, which every rank can
compute independently from the store's merged name set, with no authoritative rank.
"""

from __future__ import annotations


class NameRegistry:
    """Fixed-capacity name→index registry with deterministic distributed merge."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._ids: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, name: str) -> bool:
        return name in self._ids

    def get(self, name: str) -> int:
        """Index of ``name``, registering it locally if new."""
        idx = self._ids.get(name)
        if idx is None:
            if len(self._ids) >= self.capacity:
                raise ValueError(
                    f"name registry full ({self.capacity}); raise max_signals"
                )
            idx = len(self._ids)
            self._ids[name] = idx
        return idx

    def names(self) -> tuple[str, ...]:
        """Names in index order."""
        return tuple(sorted(self._ids, key=self._ids.__getitem__))

    def index_map(self) -> dict[str, int]:
        return dict(self._ids)

    def publish(self, store, key: str = "telemetry/names") -> None:
        """Publish local names into the store's merged set (idempotent union)."""
        store.set_add(key, list(self._ids))

    def merge(self, store, key: str = "telemetry/names") -> dict[int, int]:
        """Adopt the store's merged name set: existing names keep their slots, newly
        discovered names append in sorted order.

        Invariant: *per-rank column stability* — a name's index never changes on a
        given rank, so per-column carried state (EWMA, historical minima) stays valid
        across rounds. Indices need not agree across ranks: summaries travel keyed by
        name and each scoring rank builds its matrix from its own registry. Callers
        wanting within-round membership consistency barrier between ``publish`` and
        ``merge``. Returns old-index → new-index remap (identity for kept names)."""
        merged = store.set_get(key)
        new_names = sorted(n for n in merged if n not in self._ids)
        if len(self._ids) + len(new_names) > self.capacity:
            raise ValueError(
                f"name registry overflow after sync: {len(self._ids) + len(new_names)} "
                f"> {self.capacity}"
            )
        remap = {i: i for i in self._ids.values()}
        for n in new_names:
            self._ids[n] = len(self._ids)
        return remap

    def sync_via_store(self, store, key: str = "telemetry/names") -> dict[int, int]:
        """``publish`` + ``merge`` in one shot (single-rank or eventually-consistent
        use; the reference's NameMapper gather analogue, ``name_mapper.py:56-81``)."""
        self.publish(store, key)
        return self.merge(store, key)
