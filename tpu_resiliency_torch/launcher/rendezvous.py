"""Elastic rendezvous: a CAS state machine over the coordination KV store.

Re-design of the reference's forked dynamic rendezvous
(``fault_tolerance/_ft_rendezvous.py`` + ``rendezvous/c10d_rendezvous_backend.py``):
the same membership contract — nodes join an open round; once ``min_nodes`` have
arrived the leader waits a short last call, then closes the round, ranking the first
``max_nodes`` joiners as *active* and the surplus as *spares* (the reference's
``redundancy_list``, ``_ft_rendezvous.py:302-338``); late arrivals register as
*waiting* so agents can trigger an upscale round (``upscaling_enabled``) — but built
on the store's atomic compare-and-set instead of a vendored 3k-LoC state machine.
Node liveness rides server-clock keep-alive stamps (``touch``/``stale_keys``), the
same mechanism the in-process layer uses, rather than a bespoke keep-alive protocol.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Callable, Optional

from tpu_resiliency_torch.exceptions import BarrierTimeout, FaultToleranceError, StoreError
from tpu_resiliency_torch.platform import treecomm
from tpu_resiliency_torch.platform.store import CoordStore, StoreView
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger
from tpu_resiliency_torch.utils.tracing import span

log = get_logger(__name__)


def _membership_digest(active: list[str], spares: list[str]) -> str:
    """Order-sensitive digest of a round's cast: identical digest ⇒ identical
    agents in identical rank order, so reusing the placement is sound."""
    return hashlib.sha1(
        json.dumps([list(active), list(spares)]).encode()
    ).hexdigest()


@dataclasses.dataclass
class RendezvousSettings:
    min_nodes: int = 1
    max_nodes: int = 1
    join_timeout: float = 600.0
    #: after min_nodes arrive, how long the leader holds the round open so
    #: stragglers can join (as actives up to max_nodes, then as spares)
    last_call_timeout: float = 1.0
    keep_alive_interval: float = 2.0
    keep_alive_timeout: float = 20.0
    upscaling_enabled: bool = False
    poll_interval: float = 0.25
    #: restart fast path: when a replacement round has the same agent
    #: membership as the round being replaced (only worker processes changed),
    #: re-admit the group with a single CAS + one barrier round instead of the
    #: full open/join/last-call/close ladder
    fast_path: bool = True
    #: how long a fast-round member waits for its peers' confirmation barrier
    #: before abandoning the reused round back to the full ladder
    fast_path_timeout: float = 5.0


@dataclasses.dataclass
class RendezvousOutcome:
    round: int
    node_rank: Optional[int]  # None ⇒ this node is a spare
    active: list[str]
    spares: list[str]
    #: restart epoch captured when the round closed — supervisors compare against
    #: the live epoch to see restart requests, including ones raised while they
    #: were still spawning workers (reading the epoch only at supervise start
    #: would lose those)
    epoch: int = 0
    #: True when this placement came from the restart fast path (round reuse:
    #: one CAS + one barrier instead of the full open/join/close ladder)
    fast: bool = False

    @property
    def is_spare(self) -> bool:
        return self.node_rank is None

    @property
    def num_nodes(self) -> int:
        return len(self.active)


class StoreRendezvous:
    """Per-agent handle on the shared rendezvous state.

    State blob under ``state``::

        {"round": int, "status": "open"|"closed", "seq": int,
         "participants": {node_id: join_seq}, "waiting": {node_id: seq},
         "active": [node_id...], "spares": [node_id...]}

    All transitions are optimistic CAS on the whole blob; contention is tiny
    (node-count writers at restart boundaries only).
    """

    def __init__(self, store: StoreView, node_id: str, settings: RendezvousSettings):
        self.store = store
        self.node_id = node_id
        self.s = settings
        self._ka_thread: Optional[threading.Thread] = None
        self._ka_stop = threading.Event()
        #: (round, membership digest) of the last round this node was placed
        #: in — the fast path's reuse key: a replacement round may ride the
        #: single-CAS path only against exactly this membership
        self._last_membership: Optional[tuple[int, str]] = None
        #: round number we last published a scattered join registration for
        #: (tree-laddered join — one idempotent set per round, never repeated)
        self._scatter_round = -1

    # -- keep-alive --------------------------------------------------------

    def start_keepalive(self) -> None:
        if self._ka_thread is not None:
            return
        self._ka_stop.clear()

        def loop():
            while not self._ka_stop.is_set():
                try:
                    self.store.touch(f"ka/{self.node_id}")
                except Exception:
                    pass
                self._ka_stop.wait(self.s.keep_alive_interval)

        self._ka_thread = threading.Thread(target=loop, name="rdzv-keepalive", daemon=True)
        self._ka_thread.start()

    def stop_keepalive(self) -> None:
        self._ka_stop.set()
        if self._ka_thread is not None:
            self._ka_thread.join(5.0)
            self._ka_thread = None

    def dead_nodes(self) -> set[str]:
        """Nodes whose keep-alive went stale, by the server clock."""
        stale = self.store.stale_keys("ka/", self.s.keep_alive_timeout)
        return {k.split("/", 1)[1] for k in stale}

    def live_nodes(self) -> set[str]:
        """Every agent with a fresh keep-alive — the pool available for a round."""
        all_known = {k.split("/", 1)[1] for k in self.store.prefix_get("ka/")}
        return all_known - self.dead_nodes()

    # -- global signals ----------------------------------------------------

    def restart_epoch(self) -> int:
        return int(self.store.try_get("restart", 0))

    def watch_restart(self, wake_fn) -> "RestartWatcher":
        """A started watcher thread that calls ``wake_fn()`` whenever the
        restart epoch mutates — folds the store's ``wait_changed`` event into a
        caller-side wakeup (the agent's supervise loop), so a peer's restart
        request propagates in ~ms instead of at the next poll tick. Purely an
        accelerator: callers keep their polling checks for correctness."""
        return RestartWatcher(self.store, wake_fn)

    def request_restart(self, reason: str) -> None:
        log.info(f"[{self.node_id}] requesting restart round: {reason}")
        self.store.list_append("restart_reasons", (self.node_id, reason, time.time()))
        self.store.add("restart", 1)

    def request_shutdown(self, reason: str) -> None:
        self.store.set("shutdown", f"{self.node_id}: {reason}")

    def shutdown_reason(self) -> Optional[str]:
        return self.store.try_get("shutdown")

    def mark_done(self, round_no: int) -> None:
        self.store.set(f"done/{round_no}/{self.node_id}", True)

    def done_nodes(self, round_no: int) -> set[str]:
        return {k.rsplit("/", 1)[1] for k in self.store.prefix_get(f"done/{round_no}/")}

    def waiting_count(self) -> int:
        state = self.store.try_get("state")
        if not state or state.get("status") != "closed":
            return 0
        return len(state.get("waiting", {}))

    def set_health(self, healthy: bool, detail: str = "") -> None:
        self.store.set(f"health/{self.node_id}", (bool(healthy), detail))

    def healthy_live_nodes(self) -> set[str]:
        dead = self.dead_nodes()
        out = set()
        for k, v in self.store.prefix_get("health/").items():
            node = k.split("/", 1)[1]
            if node in dead:
                continue
            ok = v[0] if isinstance(v, (tuple, list)) else bool(v)
            if ok:
                out.add(node)
        return out

    # -- the round state machine ------------------------------------------

    def _cas(self, expected, desired) -> bool:
        ok, _ = self.store.compare_set("state", expected, desired)
        return ok

    def next_round(self, prev_round: int = -1) -> RendezvousOutcome:
        """Block until a round numbered > `prev_round` closes with us placed in it.

        The whole wait is one ``rendezvous.round`` span: its duration IS the
        re-rendezvous segment of restart latency (the p50/p95 that
        ``tools/metrics_dump.py`` reports), and in the trace it sits between a
        failed round's end and the next round's spawn."""
        with span(
            "rendezvous", "rendezvous.round",
            prev_round=prev_round, node_id=self.node_id,
        ):
            out = self._next_round(prev_round)
        # Remember the placed round's membership: the reuse key a future
        # replacement round's fast path is gated on. Placement-less outcomes
        # (idle-spare store-loss exits) must not seed a reuse key.
        if out.active:
            self._last_membership = (out.round, _membership_digest(out.active, out.spares))
        return out

    def _next_round(self, prev_round: int) -> RendezvousOutcome:
        self.start_keepalive()
        try:
            self.store.touch(f"ka/{self.node_id}")
            # Re-entering rendezvous retracts any previous exit mark: an
            # ``exit/`` key must mean "left and stayed gone" — the shrink
            # fast path below treats it as a departure vote, and a stale one
            # from an earlier life of this node_id would shrink a live member
            # out of the world.
            self.store.delete(f"exit/{self.node_id}")
        except StoreError:
            # The store host may be mid-teardown (its job finished while we
            # were between rounds). The keep-alive is advisory; the state read
            # below owns the store-lost decision (idle-spare exit vs fatal),
            # so a dead store here must not crash the agent one line early.
            pass
        deadline = time.monotonic() + self.s.join_timeout
        min_reached_at: Optional[float] = None
        me = self.node_id
        state_ver = 0
        while time.monotonic() < deadline:
            try:
                cur, state_ver = self.store.get_versioned("state")
            except StoreError:
                if prev_round < 0:
                    # Never placed and the control plane is gone: the job completed
                    # (or died) without us — behave like an idle spare.
                    return RendezvousOutcome(round=0, node_rank=None, active=[], spares=[])
                raise FaultToleranceError(
                    f"coordination store lost during re-rendezvous (node {me})"
                )
            # Case 1: no state yet, or the last closed round is stale → open anew.
            if cur is None or (cur["status"] == "closed" and cur["round"] <= prev_round):
                # Restart fast path first: when the stale round's membership is
                # exactly the cast we were placed with (same agents, same
                # order — only worker processes changed), one CAS republishes
                # it as the replacement round and the loop re-reads straight
                # into the acceptance barrier below. Any ineligibility (digest
                # mismatch, dead agent, waiting upscaler, store hiccup) falls
                # through to the full open/join/close ladder unchanged.
                if cur is not None and self._try_fast_reuse(cur, prev_round):
                    continue
                # A REOPENED round expects the previous round's whole cast
                # (actives, spares, waiting): whoever reopens first must not
                # close a splinter world at last-call while a still-live peer
                # is merely finishing its worker teardown — that splits the
                # fleet and thrashes restart rounds (each charging budget).
                prev_known = sorted(
                    set(cur.get("active", []))
                    | set(cur.get("spares", []))
                    | set(cur.get("waiting", {}))
                ) if cur else []
                nxt = {
                    "round": (cur["round"] + 1) if cur else 0,
                    "status": "open",
                    "seq": 1,
                    "participants": {me: 0},
                    "waiting": {},
                    "active": [],
                    "spares": [],
                    "expected": prev_known,
                }
                min_reached_at = None
                if self._cas(cur, nxt):
                    record_event(
                        "rendezvous", "rendezvous_opened", round=nxt["round"],
                        node_id=me, expected=prev_known,
                    )
                continue
            # Case 2: a closed round newer than what we had.
            if cur["status"] == "closed":
                if me in cur["active"]:
                    # A fast-reused round is only real once every active
                    # confirms through its barrier — a member that diverged to
                    # the full ladder (it saw a dead peer first) must starve
                    # the barrier and force the reopen, not leave a splinter
                    # world supervising orphaned workers.
                    if cur.get("fast_from") and not self._confirm_fast_round(cur):
                        continue  # abandoned: state has moved, re-read it
                    return RendezvousOutcome(
                        round=cur["round"],
                        node_rank=cur["active"].index(me),
                        active=list(cur["active"]),
                        spares=list(cur["spares"]),
                        epoch=cur.get("epoch", 0),
                        fast=bool(cur.get("fast_from")),
                    )
                if me in cur["spares"]:
                    return RendezvousOutcome(
                        round=cur["round"],
                        node_rank=None,
                        active=list(cur["active"]),
                        spares=list(cur["spares"]),
                        epoch=cur.get("epoch", 0),
                        fast=bool(cur.get("fast_from")),
                    )
                # Late arrival: advertise for the next (upscale) round.
                if me not in cur.get("waiting", {}):
                    nxt = dict(cur)
                    nxt["waiting"] = dict(cur.get("waiting", {}))
                    nxt["waiting"][me] = nxt["seq"]
                    nxt["seq"] += 1
                    self._cas(cur, nxt)
                    continue
                active = set(cur["active"])
                try:
                    done = self.done_nodes(cur["round"])
                    dead = self.dead_nodes()
                except StoreError:
                    if prev_round < 0:
                        return RendezvousOutcome(
                            round=cur["round"], node_rank=None,
                            active=list(cur["active"]), spares=list(cur["spares"]),
                        )
                    raise
                if active <= done:
                    # The job finished without needing us: report as an idle spare
                    # so the agent exits cleanly.
                    return RendezvousOutcome(
                        round=cur["round"], node_rank=None,
                        active=list(cur["active"]), spares=list(cur["spares"]),
                    )
                if active and active <= (dead | done):
                    # Every remaining active died and no survivor is left to call
                    # a restart round — a waiting node must reopen itself or the
                    # job is lost with standby capacity available.
                    nxt = {
                        "round": cur["round"] + 1,
                        "status": "open",
                        "seq": 1,
                        "participants": {me: 0},
                        "waiting": {},
                        "active": [],
                        "spares": [],
                    }
                    min_reached_at = None
                    if self._cas(cur, nxt):
                        log.info(f"[{me}] actives all dead; reopened round {cur['round'] + 1}")
                        record_event(
                            "rendezvous", "rendezvous_opened",
                            round=cur["round"] + 1, node_id=me,
                            reason="actives all dead",
                        )
                    continue
                # Registered and the job is healthy: we are standby redundancy for
                # this closed round — report as a spare now rather than blocking
                # until some future round (the reference's redundancy nodes join
                # a completed rendezvous without re-triggering it,
                # ``_ft_rendezvous.py:827-831``). The agent's spare loop handles
                # promotion, job completion, and dead-active detection from here.
                return RendezvousOutcome(
                    round=cur["round"],
                    node_rank=None,
                    active=list(cur["active"]),
                    spares=list(cur["spares"]),
                    epoch=cur.get("epoch", 0),
                )
            # Case 3: an open round.
            parts = cur["participants"]
            scatter = self._scatter_join_enabled()
            if me not in parts:
                if scatter:
                    # Tree-laddered join (the treecomm edge shape lifted onto
                    # the ladder): one idempotent ``set`` on a per-node key —
                    # hash-scattered across clique shards — instead of a CAS
                    # retry storm where every joiner read-modify-writes the
                    # ONE state key through one event loop. The leader folds
                    # registrations into ``participants`` in batches below;
                    # we park on the state key until a fold lands us.
                    if self._scatter_round != cur["round"]:
                        try:
                            treecomm.scatter_register(
                                self.store, f"join/{cur['round']}", me
                            )
                            self._scatter_round = cur["round"]
                        except StoreError:
                            pass
                else:
                    nxt = dict(cur)
                    nxt["participants"] = dict(parts)
                    nxt["participants"][me] = nxt["seq"]
                    nxt["seq"] += 1
                    self._cas(cur, nxt)
                    continue
            dead = self.dead_nodes()
            live_parts = {n: s for n, s in parts.items() if n == me or n not in dead}
            if scatter and live_parts and min(live_parts, key=live_parts.get) == me:
                # Aggregator duty rides leadership (lowest join seq): fold
                # every scattered registration in one batched CAS. A fold
                # mutates state, so every parked joiner wakes into its
                # membership at once — O(N/batch) CASes for the whole world.
                if self._fold_scattered_joins(cur, dead):
                    continue
            if len(live_parts) >= self.s.min_nodes:
                if min_reached_at is None:
                    min_reached_at = time.monotonic()
                order = sorted(live_parts, key=live_parts.get)
                i_am_leader = order[0] == me
                # Close immediately at full strength — exactly the reference's
                # behavior (``_ft_rendezvous.py:830-831`` completes the round the
                # moment ``max_nodes`` is reached; its last-call deadline applies
                # only between min and max). Surplus nodes that registered before
                # the close still land as spares (``order[max_nodes:]``); later
                # ones advertise for the next round. This takes the last-call hold
                # off the restart critical path for fixed-size jobs.
                full = len(live_parts) >= self.s.max_nodes
                waited = time.monotonic() - min_reached_at
                # Previous-round members that are live (fresh keep-alive), did
                # not exit, and have not re-registered yet: they are mid-
                # teardown on their way here — hold the close for them past
                # last-call, bounded by the keep-alive timeout (a peer that
                # stops renewing gets pruned as dead and stops blocking).
                expected_missing = set()
                if i_am_leader and not full and cur.get("expected"):
                    # Leader-only: the exit/ scan feeds only the leader's close
                    # decision — N-1 followers issuing it each tick would tax
                    # the control plane at exactly the restart-storm moment.
                    exited = {
                        k.rsplit("/", 1)[1]
                        for k in self.store.prefix_get("exit/")
                    }
                    expected_missing = (
                        set(cur["expected"]) - set(live_parts) - dead - exited
                    )
                last_call_over = full or (
                    waited >= self.s.last_call_timeout and not expected_missing
                ) or (
                    waited >= self.s.last_call_timeout + self.s.keep_alive_timeout
                )
                if i_am_leader and last_call_over:
                    active = order[: self.s.max_nodes]
                    spares = order[self.s.max_nodes :]
                    closed = {
                        "round": cur["round"],
                        "status": "closed",
                        "seq": cur["seq"],
                        "participants": dict(live_parts),
                        "waiting": {},
                        "active": active,
                        "spares": spares,
                        "epoch": self.restart_epoch(),
                    }
                    if self._cas(cur, closed):
                        log.info(
                            f"[{me}] closed rendezvous round {cur['round']}: "
                            f"active={active} spares={spares}"
                        )
                        # Leader-only close record: ``waited`` is the
                        # min-nodes→close hold (last-call + expected-peer
                        # grace), the tunable part of round-formation latency.
                        record_event(
                            "rendezvous", "rendezvous_closed",
                            round=cur["round"], node_id=me, waited_s=waited,
                            active=active, spares=spares, full=full,
                        )
                        if scatter:
                            # GC the round's scattered join keys. A joiner
                            # whose registration raced the close re-reads
                            # closed state and lands in ``waiting`` — the
                            # same late-arrival semantics as a lost CAS.
                            try:
                                treecomm.scatter_clear(
                                    self.store, f"join/{cur['round']}"
                                )
                            except StoreError:
                                pass
                    continue
            # Event-driven: any peer's CAS on the round state wakes us at once
            # (a follower learns of the leader's close in ~ms instead of up to
            # a poll interval later); the timeout keeps the time-based checks
            # (keep-alive staleness, last-call window) paced as before.
            try:
                self.store.wait_changed("state", state_ver, self.s.poll_interval)
            except StoreError:
                time.sleep(self.s.poll_interval)
        raise FaultToleranceError(
            f"rendezvous did not complete within {self.s.join_timeout}s "
            f"(node {me}, waiting for round > {prev_round})"
        )

    # -- tree-laddered join (scatter/fold) ----------------------------------

    def _scatter_join_enabled(self) -> bool:
        """Worlds at or above the tree floor join by scattered edge keys +
        leader folds; smaller worlds keep the flat per-node CAS (one op per
        joiner is already optimal there, and it's the shape every pre-tree
        test pins)."""
        tree_min = int(
            os.environ.get(treecomm.TREE_MIN_ENV, treecomm.DEFAULT_TREE_MIN)
        )
        return self.s.max_nodes >= tree_min

    def _fold_scattered_joins(self, cur: dict, dead: set[str]) -> bool:
        """Leader/aggregator half of the tree-laddered join: collect the
        round's scattered registrations (concurrent prefix scan — fans
        across clique shards) and CAS the whole batch into ``participants``
        with consecutive join seqs (sorted by node id within a batch —
        deterministic given membership). True ⇒ a fold CAS was attempted and
        the caller must re-read state before acting on it."""
        try:
            regs = treecomm.scatter_collect(self.store, f"join/{cur['round']}")
        except StoreError:
            return False
        parts = cur["participants"]
        new = sorted(n for n in regs if n not in parts and n not in dead)
        if not new:
            return False
        nxt = dict(cur)
        nxt["participants"] = dict(parts)
        for n in new:
            nxt["participants"][n] = nxt["seq"]
            nxt["seq"] += 1
        self._cas(cur, nxt)
        record_event(
            "rendezvous", "rendezvous_join_folded", round=cur["round"],
            node_id=self.node_id, folded=len(new),
        )
        return True

    # -- restart fast path (round reuse) -----------------------------------

    def _try_fast_reuse(self, cur: dict, prev_round: int) -> bool:
        """Attempt the single-CAS round reuse against stale closed state
        ``cur``. True ⇒ a CAS was attempted (ours or a peer won the race) and
        the caller should re-read state; False ⇒ ineligible, take the full
        ladder. Eligibility is strict — any doubt degrades to the ladder:

        - we were placed in exactly ``prev_round`` and ``cur`` IS that round;
        - the membership digest matches our remembered placement (same agents,
          same rank order — the "only locally-promoted ranks changed" case);
        - nobody is waiting for an upscale round (that needs the ladder's
          re-ranking);
        - every missing member of the cast is EXPLAINED: keep-alive-dead or
          exit-marked. A fully-present cast republishes unchanged (the PR-9
          worker-restart case). An explained departure set takes the SHRINK
          fast path: vacated active slots are backfilled from surviving
          spares in order (the warm-spare swap), any remainder shrinks the
          world — one CAS plus the confirmation barrier, instead of the full
          open/join/last-call ladder. An unexplained absence (a survivor that
          merely stopped answering) cannot occur by construction — absence IS
          the explanation here — but a departed *us* or an emptied active
          list degrades to the ladder.
        """
        if not self.s.fast_path or cur["round"] != prev_round:
            return False
        mem = self._last_membership
        if mem is None or mem[0] != prev_round:
            return False
        digest = _membership_digest(cur.get("active", []), cur.get("spares", []))
        if digest != mem[1]:
            return False
        me = self.node_id
        if me not in cur["active"] and me not in cur["spares"]:
            return False
        if cur.get("waiting"):
            return False
        cast = set(cur["active"]) | set(cur["spares"])
        try:
            # Departed = no fresh keep-alive (stale OR deleted — ``leave()``
            # removes the key outright) or an explicit exit mark. Every cast
            # member touched ``ka/`` when it was placed, so a missing key is
            # a departure, never a never-seen node.
            live = self.live_nodes()
            exited = {
                k.rsplit("/", 1)[1] for k in self.store.prefix_get("exit/")
            }
            epoch = self.restart_epoch()
        except StoreError:
            return False
        departed = (cast - live) | (exited & cast)
        if me in departed:
            return False
        survivors_a = [n for n in cur["active"] if n not in departed]
        survivors_s = [n for n in cur["spares"] if n not in departed]
        # Warm-spare backfill: surviving spares take vacated active slots in
        # spare order; what cannot be backfilled is the shrink.
        vacancies = len(cur["active"]) - len(survivors_a)
        new_active = survivors_a + survivors_s[:vacancies]
        new_spares = survivors_s[vacancies:]
        if not new_active or len(new_active) < self.s.min_nodes:
            return False
        nxt = {
            "round": prev_round + 1,
            "status": "closed",
            "seq": cur["seq"] + 1,
            "participants": {n: i for i, n in enumerate(new_active)},
            "waiting": {},
            "active": new_active,
            "spares": new_spares,
            "epoch": epoch,
            "fast_from": digest,
            # A later full reopen still owes the whole cast its mid-teardown
            # grace, exactly as a ladder-closed round would — departed
            # members excluded (they are gone, not mid-teardown).
            "expected": sorted(cast - departed),
        }
        try:
            ok = self._cas(cur, nxt)
        except StoreError:
            return False
        if ok:
            outcome = "shrink" if departed else "reused"
            log.info(
                f"[{me}] fast-path rendezvous ({outcome}): round "
                f"{prev_round} -> {prev_round + 1}, active={new_active} "
                f"spares={new_spares}"
                + (f" departed={sorted(departed)}" if departed else "")
            )
            record_event(
                "rendezvous", "rendezvous_fast_path", outcome=outcome,
                round=prev_round + 1, node_id=me, digest=digest,
                departed=sorted(departed),
            )
        # CAS failure means the state moved under us (a peer fast-closed the
        # same round, or opened the full ladder) — either way, re-read.
        return True

    def _confirm_fast_round(self, cur: dict) -> bool:
        """Active member's confirmation barrier for a fast-reused round. True
        once every active arrived; False after abandoning the round (barrier
        starved or store hiccup) — the caller re-reads state and proceeds
        down the full ladder.

        Large casts confirm through a tree barrier (``platform/treecomm.py``)
        instead of one flat server-side barrier: at 4096 agents the flat
        round funnels every arrival and release frame through one store event
        loop (O(N) on the release critical path); the tree's per-edge keys
        hash across a sharded clique and cap the critical path at
        O(fanout · log N). Small casts keep the flat barrier — identical to
        every pre-tree build, and one op per agent is already optimal there.
        A tree timeout abandons to the full ladder exactly like a flat one.
        """
        from tpu_resiliency_torch.platform import treecomm

        me = self.node_id
        active = cur["active"]
        tree_min = int(
            os.environ.get(treecomm.TREE_MIN_ENV, treecomm.DEFAULT_TREE_MIN)
        )
        try:
            if len(active) >= tree_min:
                fanout = int(
                    os.environ.get(
                        treecomm.TREE_FANOUT_ENV, treecomm.DEFAULT_FANOUT
                    )
                )
                tc = treecomm.TreeComm(
                    self.store.scoped(f"fastbar-tree/{cur['round']}"),
                    active.index(me),
                    len(active),
                    fanout=fanout,
                )
                tc.barrier("confirm", timeout=self.s.fast_path_timeout)
                if active.index(me) == 0:
                    # GC a LONG-finished round's tree keys (two rounds back:
                    # clearing the just-confirmed round could delete a deep
                    # member's release key before it parked on it).
                    try:
                        self.store.prefix_clear(
                            f"fastbar-tree/{cur['round'] - 2}/"
                        )
                    except StoreError:
                        pass
            else:
                self.store.barrier_join(
                    f"fastbar/{cur['round']}",
                    active.index(me),
                    len(active),
                    self.s.fast_path_timeout,
                )
            return True
        except (BarrierTimeout, StoreError) as e:
            log.warning(
                f"[{me}] fast-path round {cur['round']} confirmation failed "
                f"({e!r}); abandoning to the full ladder"
            )
            self._abandon_fast_round(cur)
            return False

    def _abandon_fast_round(self, cur: dict) -> None:
        """Demote a fast-reused round that never confirmed: CAS it to an open
        round so the full ladder re-forms the world. Best-effort — if the CAS
        fails someone else already moved the state, which is just as good."""
        nxt = {
            "round": cur["round"] + 1,
            "status": "open",
            "seq": 1,
            "participants": {self.node_id: 0},
            "waiting": {},
            "active": [],
            "spares": [],
            "expected": sorted(
                set(cur.get("active", [])) | set(cur.get("spares", []))
            ),
        }
        try:
            if self._cas(cur, nxt):
                record_event(
                    "rendezvous", "rendezvous_fast_path", outcome="abandoned",
                    round=cur["round"], node_id=self.node_id,
                )
        except StoreError:
            pass

    def mark_exited(self) -> None:
        """Record that this agent's process is leaving (success or failure)."""
        self.store.set(f"exit/{self.node_id}", True)

    def await_peers_exit(self, timeout: float = 20.0) -> None:
        """Store-host duty: hold the server up until every placed peer has either
        marked itself exited or gone keep-alive-stale — otherwise closing the store
        rips the control plane out from under agents still coordinating."""
        state = self.store.try_get("state") or {}
        peers = (
            set(state.get("active", []))
            | set(state.get("spares", []))
            | set(state.get("waiting", {}))
        )
        peers.discard(self.node_id)
        deadline = time.monotonic() + timeout
        while peers and time.monotonic() < deadline:
            exited = {k.split("/", 1)[1] for k in self.store.prefix_get("exit/")}
            remaining = peers - exited
            if not remaining:
                return
            if remaining <= self.dead_nodes():
                return
            time.sleep(0.2)

    def leave(self) -> None:
        """Best-effort departure: drop our keep-alive and waiting registration."""
        self.stop_keepalive()
        try:
            self.store.delete(f"ka/{self.node_id}")
            cur = self.store.try_get("state")
            if cur and self.node_id in cur.get("waiting", {}):
                nxt = dict(cur)
                nxt["waiting"] = {
                    n: s for n, s in cur["waiting"].items() if n != self.node_id
                }
                self._cas(cur, nxt)
        except Exception:
            pass


class RestartWatcher:
    """Daemon thread parking on the restart key's version; calls ``wake_fn``
    on every mutation. Purely an accelerator: it must never be able to delay
    or fail its owner, so the connection is built INSIDE the thread with
    minimal retries (a wedged store at round start must not stall the agent's
    supervision), every wait runs on a one-shot connection (never holding a
    client lock the owner could contend on), and ``stop`` does not block —
    the daemon thread parks out its current wait (≤ its timeout) and exits."""

    #: long enough to amortize the one-shot reconnect, and past the store
    #: client's blocking threshold so the wait never rides (and locks) a
    #: persistent socket.
    _WAIT_S = 6.0

    def __init__(self, rdzv_store, wake_fn):
        client = rdzv_store.client
        self._host, self._port = client.host, client.port
        self._prefix = rdzv_store.prefix
        self._auth_key = client.auth_key
        self._wake = wake_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="restart-watcher", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        from tpu_resiliency_torch.platform.shardstore import connect_store

        store = None
        try:
            store = connect_store(
                self._host, self._port, prefix=self._prefix,
                auth_key=self._auth_key, connect_retries=2,
            )
            _, ver = store.get_versioned("restart")
            while not self._stop.is_set():
                changed, _, ver = store.wait_changed("restart", ver, self._WAIT_S)
                if changed and not self._stop.is_set():
                    self._wake()
        except Exception:
            # On any store hiccup the owner's polling still observes the
            # epoch; don't let a watcher crash take the agent.
            pass
        finally:
            if store is not None:
                try:
                    store.close()
                except Exception:
                    pass

    def stop(self) -> None:
        """Non-blocking: flag the thread down; it exits after its current
        parked wait (daemon — it cannot outlive the process). No join, not
        even a bounded one: stop() runs in the round-teardown path of every
        restart, and the thread is parked in a multi-second store wait — a
        100 ms join timeout here was a flat 100 ms tax on EVERY respawn
        (visible as the rendezvous segment of BENCH_restart's decomposition).
        A wake racing the flag is harmless: wake_fn only sets an Event whose
        consumer re-reads store state for truth."""
        self._stop.set()
