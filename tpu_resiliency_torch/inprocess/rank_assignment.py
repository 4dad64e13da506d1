"""Rank reassignment after failures: filters, shifts, and the topology tree.

Analogue of the reference's ``inprocess/rank_assignment.py`` (filters ``:123-236``,
reassignments ``FillGaps:709`` / ``ShiftRanks:760`` / ``FilterCountGroupedByKey:812``,
and the multi-layer ``Tree:388-680``). Every rank runs the same assignment callable on
the same inputs — ``(world_size, terminated initial-ranks set)`` plus deterministic
topology keys — so all ranks independently compute identical global assignments and
read off their own slot; no extra collective is needed.

TPU re-design notes: topology keys naturally encode the ICI hierarchy (host, slice /
pod, superpod). A ``Tree`` with ``Layer(key_or_fn=lambda r: r // ranks_per_host,
flag=BACKFILL | RESERVE)`` keeps replacement ranks within a failed rank's host group
when possible, so post-restart meshes keep collectives on ICI rather than DCN. The
reference's ``Tree`` algorithm (RESERVE spare-pool search + BACKFILL swap + shift,
``rank_assignment.py:402-453``) is re-implemented here with explicitly documented
semantics rather than translated.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Union

from tpu_resiliency_torch.exceptions import RestartAbort
from tpu_resiliency_torch.inprocess.state import Mode, State


@dataclasses.dataclass
class RankAssignmentCtx:
    """Input/output of a rank-assignment chain (reference ``rank_assignment.py:42``).

    ``state`` is this rank's state (mutated in place); ``terminated_ranks`` holds
    *initial* ranks confirmed dead this round. Assignments may also raise
    :class:`RestartAbort` when the surviving pool cannot satisfy constraints.
    """

    state: State
    terminated_ranks: frozenset[int] = frozenset()
    #: advisory: ranks the health-vector policy holds degraded (alive but slow);
    #: assignments may demote them to spares but must not require their absence
    degraded_ranks: frozenset[int] = frozenset()


RankAssignment = Callable[[RankAssignmentCtx], RankAssignmentCtx]


def _survivors(ctx: RankAssignmentCtx) -> list[int]:
    return [
        r for r in range(ctx.state.initial_world_size) if r not in ctx.terminated_ranks
    ]


def _apply_global(ctx: RankAssignmentCtx, assignment: dict[int, Optional[int]]) -> RankAssignmentCtx:
    """Write this rank's slot from a globally-computed {initial_rank: active_rank|None}."""
    me = ctx.state.initial_rank
    if me in ctx.terminated_ranks:
        ctx.state.mode = Mode.TERMINATED
        ctx.state.active_rank = None
        return ctx
    active_world = sum(1 for v in assignment.values() if v is not None)
    slot = assignment.get(me)
    if slot is None:
        ctx.state.mode = Mode.INACTIVE
        ctx.state.active_rank = None
    else:
        ctx.state.mode = Mode.ACTIVE
        ctx.state.active_rank = slot
    ctx.state.active_world_size = active_world
    return ctx


# -- filters (choose ACTIVE vs INACTIVE) -----------------------------------


class ActivateAllRanks:
    """Every survivor is active, renumbered densely (reference ``:123``)."""

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        surv = _survivors(ctx)
        return _apply_global(ctx, {r: i for i, r in enumerate(surv)})


class ShiftRanks:
    """Survivors keep relative order, shifted left over gaps (reference ``:760``)."""

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        surv = _survivors(ctx)
        return _apply_global(ctx, {r: i for i, r in enumerate(surv)})


class FillGaps:
    """Survivors keep their slot when possible; tail survivors move into gaps left by
    the terminated (reference ``:709``). Minimizes the number of ranks whose identity
    changes — fewer recompilations / resharded restores after restart."""

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        surv = _survivors(ctx)
        n = len(surv)
        keep = [r for r in surv if r < n]
        movers = [r for r in surv if r >= n]
        gaps = sorted(set(range(n)) - set(keep))
        assignment: dict[int, Optional[int]] = {r: r for r in keep}
        for gap, mover in zip(gaps, movers):
            assignment[mover] = gap
        return _apply_global(ctx, assignment)


@dataclasses.dataclass
class MaxActiveWorldSize:
    """Cap the active world; excess survivors become INACTIVE spares (reference ``:146``)."""

    max_active_world_size: Optional[int] = None

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        cap = self.max_active_world_size
        surv = _survivors(ctx)
        n = len(surv) if cap is None else min(cap, len(surv))
        assignment: dict[int, Optional[int]] = {}
        for i, r in enumerate(surv):
            assignment[r] = i if i < n else None
        return _apply_global(ctx, assignment)


@dataclasses.dataclass
class DemoteDegraded:
    """Health-vector demotion: degraded-but-alive ranks yield their active slots to
    healthy spares (the decisions loop of BASELINE target 5).

    Survivors are ordered healthy-first (each group keeping ascending initial-rank
    order) and the first ``max_active_world_size`` become ACTIVE — so a degraded
    rank drops to INACTIVE reserve exactly when a healthy rank exists to take its
    place, and fills in (better slow than absent) when none does. With
    ``max_active_world_size=None`` every survivor stays active and degraded ranks
    are merely renumbered last (useful to pin them to the tail of the mesh).
    """

    max_active_world_size: Optional[int] = None

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        surv = _survivors(ctx)
        healthy = [r for r in surv if r not in ctx.degraded_ranks]
        degraded = [r for r in surv if r in ctx.degraded_ranks]
        ordered = healthy + degraded
        cap = self.max_active_world_size
        n = len(ordered) if cap is None else min(cap, len(ordered))
        assignment: dict[int, Optional[int]] = {}
        for i, r in enumerate(ordered):
            assignment[r] = i if i < n else None
        return _apply_global(ctx, assignment)


@dataclasses.dataclass
class ActiveWorldSizeDivisibleBy:
    """Round the active world down to a multiple (mesh-shape constraint; reference ``:188``)."""

    divisor: int = 1

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        surv = _survivors(ctx)
        n = (len(surv) // self.divisor) * self.divisor
        if n == 0:
            raise RestartAbort(
                f"{len(surv)} survivors cannot form a world divisible by {self.divisor}"
            )
        assignment: dict[int, Optional[int]] = {}
        for i, r in enumerate(surv):
            assignment[r] = i if i < n else None
        return _apply_global(ctx, assignment)


@dataclasses.dataclass
class FilterCountGroupedByKey:
    """Keep only groups whose survivor count satisfies a predicate (reference ``:812``).

    ``key_or_fn`` maps an initial rank to its group key (e.g. host index); groups
    failing ``count_predicate`` have all their members demoted to INACTIVE.
    """

    key_or_fn: Callable[[int], object]
    count_predicate: Callable[[int], bool]

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        surv = _survivors(ctx)
        groups: dict[object, list[int]] = {}
        for r in surv:
            groups.setdefault(self.key_or_fn(r), []).append(r)
        kept = [r for key, members in groups.items() if self.count_predicate(len(members)) for r in members]
        kept.sort()
        return _apply_global(ctx, {r: (kept.index(r) if r in kept else None) for r in surv})


# -- topology tree ---------------------------------------------------------


class LayerFlag(enum.Flag):
    NONE = 0
    #: demoted/spare ranks at this layer stay usable as backfill elsewhere
    RESERVE = enum.auto()
    #: groups at this layer accept backfill ranks into termination holes
    BACKFILL = enum.auto()


@dataclasses.dataclass
class Layer:
    """One level of the topology hierarchy (reference ``rank_assignment.py:245``).

    ``key_or_fn``: maps initial rank → group key at this layer (``None`` = one group).
    ``min_ranks``: a group with fewer live members is dissolved (members → spare pool).
    ``max_ranks``: live members beyond this cap are demoted (lowest ranks kept).
    """

    min_ranks: int = 1
    max_ranks: Optional[int] = None
    key_or_fn: Optional[Union[Callable[[int], object], Sequence[object]]] = None
    flag: LayerFlag = LayerFlag.NONE

    def key(self, rank: int) -> object:
        if self.key_or_fn is None:
            return 0
        if callable(self.key_or_fn):
            return self.key_or_fn(rank)
        return self.key_or_fn[rank]


@dataclasses.dataclass
class Tree:
    """Multi-layer topology-aware assignment (re-design of reference ``Tree:388-680``).

    Semantics (deterministic, identical on every rank):

    1. Ranks are grouped hierarchically by each layer's key, outermost layer first.
    2. Bottom-up, each group's *live* member count is checked against the layer's
       ``min_ranks``/``max_ranks``. Under-minimum groups dissolve into the spare pool
       of their parent; over-maximum groups demote their highest-ranked extras.
    3. Where a layer has ``BACKFILL``, groups below that layer's ``max_ranks`` are
       topped back up from the spare pool (lowest spare rank first, groups visited in
       deterministic key order). Spares only exist where some layer flagged
       ``RESERVE`` contributed them, and they surface to the nearest enclosing
       ``BACKFILL`` layer — so keys that mirror the ICI hierarchy keep repairs local.
    4. Surviving active ranks are densely renumbered in initial-rank order (shift).

    ``world_size_filter`` optionally post-constrains the total (e.g. divisibility for
    a fixed mesh shape).
    """

    layers: list[Layer]
    world_size_filter: Optional[Callable[[int], int]] = None

    def __call__(self, ctx: RankAssignmentCtx) -> RankAssignmentCtx:
        world = ctx.state.initial_world_size
        alive = [r for r in range(world) if r not in ctx.terminated_ranks]
        if not self.layers:
            return ActivateAllRanks()(ctx)

        paths = {r: tuple(layer.key(r) for layer in self.layers) for r in alive}
        active, spares = self._assign_level(alive, paths, level=0)

        if self.world_size_filter is not None:
            target = self.world_size_filter(len(active))
            if target <= 0:
                raise RestartAbort(
                    f"world_size_filter reduced {len(active)} active ranks to {target}"
                )
            if target < len(active):
                demoted = sorted(active)[target:]
                spares.extend(demoted)
                active = sorted(active)[:target]

        assignment: dict[int, Optional[int]] = {r: None for r in alive}
        for i, r in enumerate(sorted(active)):
            assignment[r] = i
        return _apply_global(ctx, assignment)

    # The recursion returns (active ranks, spare ranks) for one subtree.
    def _assign_level(
        self, ranks: list[int], paths: dict[int, tuple], level: int
    ) -> tuple[list[int], list[int]]:
        if level == len(self.layers):
            return list(ranks), []
        layer = self.layers[level]
        groups: dict[object, list[int]] = {}
        for r in ranks:
            groups.setdefault(paths[r][level], []).append(r)

        group_active: dict[object, list[int]] = {}
        pool: list[int] = []  # spares available at this level
        for key in sorted(groups, key=repr):
            sub_active, sub_spares = self._assign_level(groups[key], paths, level + 1)
            pool.extend(sub_spares)
            sub_active.sort()
            if layer.max_ranks is not None and len(sub_active) > layer.max_ranks:
                extras = sub_active[layer.max_ranks :]
                sub_active = sub_active[: layer.max_ranks]
                if layer.flag & LayerFlag.RESERVE:
                    pool.extend(extras)
            if len(sub_active) < layer.min_ranks:
                # Group dissolved; members become spares if this layer reserves them.
                if layer.flag & LayerFlag.RESERVE:
                    pool.extend(sub_active)
                continue
            group_active[key] = sub_active

        if layer.flag & LayerFlag.BACKFILL and pool:
            pool.sort()
            cap = layer.max_ranks
            for key in sorted(group_active, key=repr):
                if cap is None:
                    break  # no defined target size to fill toward
                members = group_active[key]
                while len(members) < cap and pool:
                    members.append(pool.pop(0))
                members.sort()

        active = [r for members in group_active.values() for r in members]
        return active, pool


