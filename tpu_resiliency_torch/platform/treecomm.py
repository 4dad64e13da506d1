"""Tree-structured barriers and gathers over the coordination store.

The flat collectives the store grew up with put O(N) work on ONE event loop:
a full-world barrier is N arrivals serialized through one selector thread and
N release frames sent from it; a flat ``all_gather`` adds N ``prefix_get``
responses each carrying the whole world's values. ``BENCH_store_baseline.json``
records the resulting curve — p50 37 µs at 1 client, 3.3 ms at 64 — and every
subsystem since PR 4 (reshard holder-gather, metrics push, barrier census,
fleet leases) stacked onto it.

This module restructures the two collective shapes through a ``fanout``-ary
tree over the *group index space* (0..world-1, parent of ``i`` is
``(i-1)//fanout``), so the critical path is O(fanout · log_fanout N) store
round trips instead of O(N), and — the compounding move — every tree edge is
its own store *key*, so under a sharded clique (``platform/shardstore.py``)
the edges hash across shards and no single event loop serializes the round.

Two primitives, both built from the store's existing parked-wait ops (no new
wire ops, no server change — an unmodified or even pre-epoll server serves
them):

- :func:`tree_barrier` — reentrant: per-tag edge keys hold round *numbers*
  (``u/{i}`` = "subtree i fully arrived for round r", ``d/{i}`` = "round r
  released down to i"), so repeated rounds mutate 2N small int keys instead
  of minting namespace. Waits ride ``wait_changed`` (event-driven, parked
  server-side — never a poll loop).
- :func:`tree_all_gather` — round-scoped fan-in of value dicts up the tree,
  result fan-out down per-child keys (each rank's result wait parks on its
  OWN key — shard-local, no thundering herd on one key), then an ack fan-in
  so index 0 deletes the round's keys only after every rank has read.

Failure semantics match the flat collectives: a dead rank starves its
ancestors' edge waits and the deadline surfaces as :class:`BarrierTimeout`
(callers treat that as fatal, exactly as before); transport faults under the
waits land on the client's existing retry/dedup ladder — every op here is
idempotent (set/get/wait_changed), so blind retries are safe. Proxy
(``on_behalf``) completion is NOT supported on tree rounds — restart-protocol
barriers that monitors complete for dead ranks stay on the flat server-side
barrier op.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from tpu_resiliency_torch.exceptions import BarrierTimeout, StoreTimeoutError

#: Env knobs (read by the consumers — StoreComm, rendezvous — not here):
#: tree arity, and the smallest world a collective switches to tree shape at.
TREE_FANOUT_ENV = "TPU_RESILIENCY_STORE_TREE_FANOUT"
TREE_MIN_ENV = "TPU_RESILIENCY_STORE_TREE_MIN"
DEFAULT_FANOUT = 8
#: Worlds below this stay flat: at ≤16 members the flat barrier's single
#: server-side op per rank beats the tree's extra edge round trips, and the
#: restart-protocol's proxy-completion semantics (flat-only) keep working for
#: every group the monitors actually watch today.
DEFAULT_TREE_MIN = 17


def children(i: int, world: int, fanout: int) -> list[int]:
    """Child indices of node ``i`` in the ``fanout``-ary heap layout."""
    lo = fanout * i + 1
    return list(range(lo, min(lo + fanout, world)))


# -- scattered registration (the rendezvous join ladder's edge shape) --------
#
# The tree collectives above assume the group is already ranked. The
# rendezvous JOIN phase can't be — ranks don't exist until the round closes —
# so its tree-laddered form uses the degenerate one-level tree: every joiner
# publishes one *edge key* of its own (hash-scattered across a sharded
# clique, exactly like the barrier edges above), and the single aggregator
# (the round's opener/leader) folds them with concurrent prefix scans. That
# turns N contended CAS retries on ONE state key — each retry a full
# read-modify-write round trip through one event loop — into N independent
# one-hop sets plus O(N/batch) scans on the leader, the same
# serialization-killing move as the tree barrier's per-edge keys.

def scatter_register(store, scope: str, member: str, payload: Any = 1) -> None:
    """Publish ``member``'s registration under its own edge key — one
    idempotent ``set`` (safe under blind retry), no CAS, no contention."""
    store.set(f"{scope}/{member}", payload)


def scatter_collect(store, scope: str) -> dict[str, Any]:
    """Aggregator side: every registered member (name → payload), via the
    store's concurrent prefix scan (fans across clique shards)."""
    out = {}
    for k, v in store.prefix_get(f"{scope}/").items():
        out[k.rsplit("/", 1)[1]] = v
    return out


def scatter_clear(store, scope: str) -> int:
    """GC a finished scope's edge keys (aggregator, post-close)."""
    return store.prefix_clear(f"{scope}/")


def parent(i: int, fanout: int) -> int:
    return (i - 1) // fanout


def tree_depth(world: int, fanout: int) -> int:
    """Levels below the root (0 for a single-node tree)."""
    d, i = 0, world - 1
    while i > 0:
        i = parent(i, fanout)
        d += 1
    return d


def tree_hops(world: int, fanout: int) -> int:
    """Store round trips on the release critical path of one tree round:
    each level's deepest parent absorbs ≤ ``fanout`` child signals going up
    and emits ≤ ``fanout`` going down, plus the root's turn-around."""
    d = tree_depth(world, fanout)
    return 2 * fanout * d + 2


def flat_hops(world: int) -> int:
    """Serialized ops on the flat collective's critical path: N arrivals
    through one event loop, then N release/read responses from it."""
    return 2 * world


class TreeComm:
    """Tree collectives for one member of a fixed group.

    ``store`` is any :class:`~tpu_resiliency_torch.platform.store.StoreView`-shaped
    object; ``index`` is this member's position in the group's sorted order
    (the tree runs in index space — callers map ranks to indices). Instances
    carry per-tag round counters, so every member must call each tagged
    collective the same number of times in the same order (the usual
    collective contract, identical to the flat paths).
    """

    def __init__(self, store, index: int, world: int, fanout: int = DEFAULT_FANOUT):
        if not 0 <= index < world:
            raise ValueError(f"index {index} outside world {world}")
        self.store = store
        self.index = index
        self.world = world
        self.fanout = max(2, int(fanout))
        self._kids = children(index, world, self.fanout)
        self._brounds: dict[str, int] = {}
        self._grounds: dict[str, int] = {}
        self._bcrounds: dict[str, int] = {}
        #: last-seen mutation versions of the reentrant barrier edge keys,
        #: so each wait_changed parks from where the previous round left off
        #: instead of re-reading history.
        self._seen: dict[str, int] = {}
        #: client-side op counter — the measured half of the hop accounting
        #: (``scripts/bench_store.py`` records it next to the analytic
        #: :func:`tree_hops` / :func:`flat_hops` figures).
        self.ops = 0

    # -- key-wait plumbing --------------------------------------------------

    def _await_value(self, key: str, want: int, deadline: float, tag: str) -> None:
        """Park until integer ``key`` reaches ``want`` (values are round
        numbers — monotonic, so ``>=`` absorbs a racing later round)."""
        self.ops += 1
        value, version = self.store.get_versioned(key)
        self._seen[key] = version
        while not (isinstance(value, int) and value >= want):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise BarrierTimeout(
                    f"tree barrier {tag!r}: timed out waiting for {key} "
                    f"to reach round {want} (index {self.index}/{self.world})"
                )
            self.ops += 1
            changed, value, version = self.store.wait_changed(
                key, self._seen[key], timeout=min(remaining, 30.0)
            )
            if changed:
                self._seen[key] = version

    def _set(self, key: str, value: Any) -> None:
        self.ops += 1
        self.store.set(key, value)

    def _get(self, key: str, timeout: float, tag: str) -> Any:
        self.ops += 1
        try:
            return self.store.get(key, timeout=max(0.0, timeout))
        except StoreTimeoutError as e:
            raise BarrierTimeout(
                f"tree collective {tag!r}: timed out waiting for {key} "
                f"(index {self.index}/{self.world})"
            ) from e

    # -- barrier ------------------------------------------------------------

    def barrier(self, tag: str = "barrier", timeout: float = 300.0) -> int:
        """Tree-structured barrier round; returns the completed round number.

        Up phase: every node waits for each child subtree's arrival key to
        reach this round, then publishes its own (the root's publication is
        implicit — collecting its children IS global arrival). Down phase:
        release propagates parent→child through per-child keys, so each
        waiter parks on its own key and the wake fan-out is ``fanout`` sets
        per node, not N frames from one loop.
        """
        r = self._brounds.get(tag, 0) + 1
        self._brounds[tag] = r
        deadline = time.monotonic() + timeout
        up, down = f"{tag}/u", f"{tag}/d"
        for c in self._kids:
            self._await_value(f"{up}/{c}", r, deadline, tag)
        if self.index != 0:
            self._set(f"{up}/{self.index}", r)
            self._await_value(f"{down}/{self.index}", r, deadline, tag)
        for c in self._kids:
            self._set(f"{down}/{c}", r)
        return r

    # -- all_gather ---------------------------------------------------------

    def all_gather(self, obj: Any, tag: str = "ag", timeout: float = 300.0) -> list:
        """Returns ``[obj_from_index]`` ordered by group index.

        Fan-in: each node merges its children's value dicts with its own and
        publishes the merged dict one level up — every level moves the
        world's values once, so total bytes are O(N log N) up plus the
        irreducible O(N · world_bytes) result fan-out (every member needs
        every value; that part no topology can shrink). Fan-out: the root's
        assembled result propagates parent→child on per-child keys. Ack
        fan-in: a node acks only after it AND its subtree have read, and
        index 0 deletes the round's namespace only after its own ack wait —
        the tree-shaped version of the flat path's exit barrier.
        """
        r = self._grounds.get(tag, 0)
        self._grounds[tag] = r + 1
        deadline = time.monotonic() + timeout
        base = f"{tag}/r{r}"
        merged: dict[int, Any] = {self.index: obj}
        for c in self._kids:
            sub = self._get(
                f"{base}/v/{c}", deadline - time.monotonic(), tag
            )
            merged.update(sub)
        if self.index == 0:
            if len(merged) != self.world:
                # Every subtree reported, yet values are missing: the store
                # lost state mid-round (restart) — surface, don't truncate.
                raise BarrierTimeout(
                    f"tree all_gather {tag!r} round {r}: root assembled "
                    f"{len(merged)}/{self.world} values"
                )
            result = merged
        else:
            self._set(f"{base}/v/{self.index}", merged)
            result = self._get(
                f"{base}/res/{self.index}", deadline - time.monotonic(), tag
            )
        for c in self._kids:
            self._set(f"{base}/res/{c}", result)
        # Read-complete ack up the tree, then the root GCs the round. An ack
        # means "me and my whole subtree have read", so when the root's ack
        # waits drain, nobody can still be parked under this round's keys.
        self._ack_and_gc(base, deadline, tag)
        return [result[i] for i in range(self.world)]

    def _ack_and_gc(self, base: str, deadline: float, tag: str) -> None:
        for c in self._kids:
            self._get(f"{base}/a/{c}", deadline - time.monotonic(), tag)
        if self.index != 0:
            self._set(f"{base}/a/{self.index}", 1)
        else:
            self.ops += 1
            self.store.prefix_clear(f"{base}/")

    # -- broadcast ----------------------------------------------------------

    def broadcast(
        self, obj: Any, src_index: int, tag: str = "bc", timeout: float = 300.0
    ) -> Any:
        """One value, source → everyone, through the tree.

        The source publishes under one round-scoped key (one hop — unless it
        IS the root); the root fans the value out parent→child on per-child
        keys exactly like :meth:`all_gather`'s result phase, so no single
        store loop serves N waiters and the critical path stays
        O(fanout · log N). Same ack fan-in + root GC as ``all_gather``.
        The flat broadcast parked the whole world on ONE key — the wake was
        N frames from one event loop, the shape this module exists to kill.
        """
        r = self._bcrounds.get(tag, 0)
        self._bcrounds[tag] = r + 1
        deadline = time.monotonic() + timeout
        base = f"{tag}/r{r}"
        if self.index == src_index:
            result = obj
            if self.index != 0:
                self._set(f"{base}/v", obj)
        if self.index == 0:
            result = obj if src_index == 0 else self._get(
                f"{base}/v", deadline - time.monotonic(), tag
            )
        elif self.index != src_index:
            result = self._get(
                f"{base}/res/{self.index}", deadline - time.monotonic(), tag
            )
        for c in self._kids:
            self._set(f"{base}/res/{c}", result)
        self._ack_and_gc(base, deadline, tag)
        return result
