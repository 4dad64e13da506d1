"""Restart-coordination protocol over the platform KV store.

One place defining the key schema and operations shared by the three restart actors —
the wrapper restart loop (``wrap.py``), the in-rank monitor thread
(``monitor_thread.py``), and the out-of-process monitor (``monitor_process.py``) — the
re-design of the reference's ``inprocess/store.py`` ``StoreMixin`` contract plus the
barrier-completion duties of ``monitor_process.py:260-282`` / ``sibling_monitor.py``.

Schema (under the wrapper's store prefix):

- ``iteration``                  — current restart iteration (every live rank re-sets it)
- ``terminated``                 — cumulative set of dead/excluded initial ranks
- ``hb/{rank}``                  — per-rank monitor-process heartbeats (wall time)
- ``iter/{i}/interrupted``       — flag: some rank was interrupted this iteration
- ``iter/{i}/interruptions``     — list of InterruptionRecord
- ``iter/{i}/completed``         — flag: some active rank finished the wrapped fn
- ``barrier/iteration/{i}``      — end-of-round resync barrier (full initial world)
- ``barrier/completion/{i}``     — success-path barrier (full initial world)

Barriers always declare the **initial** world size; ranks that can't join themselves
are joined on-behalf (idempotently) by their own monitor process or by the sibling
watcher that detected their death. That keeps barrier membership static — survivors
never need to agree on a shrinking world mid-round (the subtle correctness core called
out in SURVEY §7).
"""

from __future__ import annotations

import time
from typing import Optional

from tpu_resiliency_torch.exceptions import BarrierTimeout, StoreError, StoreTimeoutError
from tpu_resiliency_torch.inprocess.attribution import Interruption, InterruptionRecord
from tpu_resiliency_torch.platform.store import StoreView


class CompletionInterrupted(Exception):
    """Raised out of the completion-barrier wait when a peer's interruption record
    lands first: the completer must fall back into the restart path with everyone
    else instead of burning the full barrier timeout."""

    def __init__(self, iteration: int):
        super().__init__(f"interruption recorded during completion of iter {iteration}")
        self.iteration = iteration


class RestartCoordinator:
    def __init__(self, store: StoreView, world_size: int):
        self.store = store
        self.world_size = world_size

    # -- iteration tracking ------------------------------------------------

    def publish_iteration(self, iteration: int) -> None:
        self.store.set("iteration", iteration)

    def current_iteration(self, timeout: float = 0.0) -> Optional[int]:
        try:
            return self.store.get("iteration", timeout=timeout)
        except StoreTimeoutError:
            return None

    def set_job_done(self) -> None:
        self.store.set("job_done", True)

    def job_done(self) -> bool:
        return bool(self.store.try_get("job_done", False))

    # -- interruption records ---------------------------------------------

    def record_interruption(
        self,
        iteration: int,
        rank: int,
        kind: Interruption,
        message: str | None = None,
    ) -> None:
        rec = InterruptionRecord(rank=rank, interruption=kind, message=message)
        self.store.list_append(f"iter/{iteration}/interruptions", rec)
        self.store.set(f"iter/{iteration}/interrupted", True)

    def wait_interrupted(self, iteration: int, timeout: float) -> bool:
        try:
            self.store.get(f"iter/{iteration}/interrupted", timeout=timeout)
            return True
        except StoreTimeoutError:
            return False

    def is_interrupted(self, iteration: int) -> bool:
        return bool(self.store.try_get(f"iter/{iteration}/interrupted", False))

    def get_interruptions(self, iteration: int) -> list[InterruptionRecord]:
        return self.store.list_get(f"iter/{iteration}/interruptions")

    # -- completion --------------------------------------------------------

    def mark_completed(self, iteration: int) -> None:
        self.store.set(f"iter/{iteration}/completed", True)

    def is_completed(self, iteration: int) -> bool:
        return bool(self.store.try_get(f"iter/{iteration}/completed", False))

    # -- terminated ranks --------------------------------------------------

    def record_terminated(self, ranks) -> None:
        self.store.set_add("terminated", list(ranks))

    def terminated_ranks(self) -> frozenset[int]:
        return frozenset(self.store.set_get("terminated"))

    # -- degraded ranks (health-vector policy) -----------------------------

    def set_degraded(self, ranks) -> None:
        """Replace the advisory degraded set (telemetry policy output). Unlike
        ``terminated``, degraded status is reversible — a recovered rank leaves the
        set — so this is a plain value, not a grow-only set."""
        self.store.set("degraded", sorted(int(r) for r in ranks))

    def degraded_ranks(self) -> frozenset[int]:
        return frozenset(self.store.try_get("degraded", ()) or ())

    # -- heartbeats (monitor processes) ------------------------------------

    def heartbeat(self, rank: int) -> None:
        """Stamped with the *server's* clock so staleness never depends on cross-host
        NTP agreement (a 35 s clock step must not read as a 35 s-stale heartbeat)."""
        self.store.touch(f"hb/{rank}")

    def heartbeats(self) -> dict[int, float]:
        raw = self.store.prefix_get("hb/")
        out: dict[int, float] = {}
        for k, v in raw.items():
            try:
                out[int(k.rsplit("/", 1)[-1])] = float(v)
            except (ValueError, TypeError):
                continue
        return out

    def stale_peers(self, max_age: float) -> dict[int, float]:
        """Ranks whose heartbeat is older than `max_age` by the server clock, as
        ``{rank: age}``. The server returns only the stale set, so the per-tick
        liveness poll costs O(stale) on the wire regardless of world size."""
        raw = self.store.stale_keys("hb/", max_age)
        out: dict[int, float] = {}
        for k, age in raw.items():
            try:
                out[int(k.rsplit("/", 1)[-1])] = float(age)
            except (ValueError, TypeError):
                continue
        return out

    # -- barriers ----------------------------------------------------------

    def join_iteration_barrier(self, iteration: int, rank: int, timeout: float) -> None:
        self.store.barrier_join(
            f"barrier/iteration/{iteration}", rank, self.world_size, timeout
        )

    def join_completion_barrier(
        self,
        iteration: int,
        rank: int,
        timeout: float,
        poll_interval: float = 0.5,
    ) -> None:
        """Wait on the success-path barrier, but keep watching the interruption flag.

        A completer must not sit blind for the whole `timeout` while a peer's fault is
        already on record — that stall would outlast the faulted peer's iteration
        barrier and eject a healthy rank. So: register arrival without blocking, then
        poll barrier release vs. interruption; an interruption wins immediately and
        surfaces as :class:`CompletionInterrupted`.
        """
        name = f"barrier/completion/{iteration}"
        status = self.store.barrier_status(name)
        start_gen = status["generation"] if status else 0
        self.store.barrier_join(name, rank, self.world_size, timeout=0.0, wait=False)
        deadline = time.monotonic() + timeout
        while True:
            try:
                status = self.store.barrier_status(name)
                if status is not None and status["generation"] > start_gen:
                    return
                if self.is_interrupted(iteration):
                    raise CompletionInterrupted(iteration)
            except StoreError:
                # The coordinator (rank 0 hosts the server in-process) tore the store
                # down — it only does that after ITS completion barrier released, so
                # the round completed; treat server loss between polls as release.
                return
            if time.monotonic() >= deadline:
                raise BarrierTimeout(f"barrier {name!r} timed out after {timeout}s")
            time.sleep(poll_interval)

    def complete_barriers_for(self, iteration: int, rank: int) -> None:
        """Non-blocking on-behalf join of both of an iteration's barriers (idempotent)."""
        for name in (f"barrier/iteration/{iteration}", f"barrier/completion/{iteration}"):
            self.store.barrier_join(
                name, rank, self.world_size, timeout=0.0, wait=False, on_behalf=True
            )

    # -- garbage collection ------------------------------------------------

    def cleanup_iteration(self, iteration: int) -> None:
        """Drop a finished iteration's records, flags, and barriers. Called once the
        *next* iteration's resync barrier has released, at which point no live rank —
        and no proxy, which always targets the current iteration — can touch round
        `iteration` again; without this the store grows for the job's lifetime."""
        if iteration < 0:
            return
        self.store.prefix_clear(f"iter/{iteration}/")
        # Exact deletes: a prefix match on "barrier/iteration/1" would also take
        # iterations 10..19 with it.
        self.store.barrier_del(f"barrier/iteration/{iteration}")
        self.store.barrier_del(f"barrier/completion/{iteration}")
