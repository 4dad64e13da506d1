"""Sharded coordination-store clique: one keyspace over N server processes.

One :class:`~tpu_resiliency_torch.platform.store.KVServer` is a single-threaded
event loop — by design (no locks, parked continuations instead of blocked
threads), and measured flat in *connection* count, but its op throughput is
one core's dict-op rate. At 4096 ranks every subsystem's traffic (rendezvous
CAS, barrier storms, heartbeat touches, metrics pushes, reshard
holder-gathers) funnels through that one loop and queue wait dominates —
``BENCH_store_baseline.json``'s 37 µs → 3.3 ms p50 curve from 1 → 64 clients
is that funnel.

This module scales the plane *horizontally* without touching the wire
protocol or the server: a **clique** of ordinary ``KVServer`` processes plus
a client-side deterministic key→shard map. :class:`ShardedKVClient` exposes
the exact :class:`~tpu_resiliency_torch.platform.store.KVClient` surface;
single-key ops route by ``crc32(key) % nshards`` (stable across processes
and Python runs — never ``hash()``, which is salted per process), and the
prefix/scan ops fan out to every shard and merge. Three properties make the
layering safe with zero server changes:

- **Barriers and parks are shard-local by construction**: a barrier name, a
  watched key, and a parked ``get`` all hash to exactly one shard, so the
  server-side wait/notify machinery never spans shards.
- **The at-most-once dedup ladder is per shard for free**: each shard is
  served by its own underlying ``KVClient``, whose ``req_id`` nonces and
  retry budget apply against that shard's dedup LRU; a retry can only replay
  against the shard that saw the original.
- **Circuit breakers are per endpoint already** (keyed ``(host, port)`` in
  ``platform/store.py``), so one dead shard fails fast without poisoning the
  others' budgets.

A 1-shard clique degenerates to today's layout exactly — same keys, same
server, one persistent connection — which is the version-skew contract
``tests/platform/test_store_skew.py`` pins.

Discovery: the launcher exports ``$TPU_RESILIENCY_STORE_SHARDS`` as a
comma-separated ``host:port`` list (shard order IS the hash order — every
client must see the identical list); :func:`connect_store` honors it and
falls back to the classic single-endpoint env pair.

**HA (successor replication).** With ``replicate=True`` (launcher
``--store-replicate`` → ``$TPU_RESILIENCY_STORE_REPLICATE``) every key is
written to its primary shard ``h = crc32(key) % N`` *and* to the successor
``(h + 1) % N``. The double-write is safe precisely because of the existing
machinery: idempotent ops replay harmlessly, and non-idempotent ops
(``add``, ``barrier``) ride each shard's own req_id dedup LRU — the replica
copy is an independent dedup'd call, not a replayed frame. On shard
transport failure (retry budget exhausted → circuit breaker open) the
client fails over reads, watch-parks, barriers, and dedup'd mutations to
the successor, emitting ``store_failover`` events →
``tpu_store_failover_total{shard,outcome}``. Barrier arrivals are mirrored
(a non-blocking replica join precedes every primary join), so a shard
SIGKILLed mid-round strands nobody: stragglers fail over and the
successor's mirrored count releases the round exactly once per joiner.
A 1-shard clique with replication enabled degenerates exactly: successor ==
primary, so every mirror branch is skipped (zero double-writes).

**Live resharding (epoch protocol).** A clique changes size — or replaces a
dead shard with a fresh ``KVServer`` — through an epoch'd shard map CAS'd
under the raw :data:`EPOCH_KEY` on shard 0 (mirrored to its successor and
to the new map's shard 0). :func:`reshard_clique` bumps the epoch with
``prev`` set (the dual-route window), migrates the value keyspace by
concurrent prefix scan, then settles (``prev: None``). Clients never poll:
they probe the epoch key only when an op exhausts both primary and
successor, adopt any newer map, and retry once. During the window writes go
to the new map *and* write-through to the old primary, reads fall back to
the old map on a miss, and barriers stay on the old map — so old-map and
new-map clients interoperate until settle. A client that cannot find a
usable newer map fails closed with the original transport error (or a
descriptive :class:`StoreError` when the epoch document is malformed).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import zlib
from typing import Any, Iterable, Optional

from tpu_resiliency_torch.exceptions import (
    BarrierOverflow,
    BarrierTimeout,
    StoreError,
    StoreTransportError,
)
from tpu_resiliency_torch.platform.store import (
    AUTH_KEY_ENV,
    KVClient,
    KVServer,
    StoreView,
    breaker_open,
    store_answers,
)
from tpu_resiliency_torch.utils.events import record as record_event
from tpu_resiliency_torch.utils.logging import get_logger

log = get_logger(__name__)

SHARDS_ENV = "TPU_RESILIENCY_STORE_SHARDS"

#: "1"/"true"/"on" turns on successor replication for every clique client
#: built from the environment (the launcher's ``--store-replicate`` export).
REPLICATE_ENV = "TPU_RESILIENCY_STORE_REPLICATE"

#: Reserved raw key on shard 0 where a clique's spawner publishes the full
#: endpoint list. A client handed only the classic ``host:port`` endpoint
#: (another agent, a diagnostic tool) probes it once and, if present,
#: reconnects as a sharded client — late joiners cannot split the keyspace
#: by talking to shard 0 alone.
CLIQUE_KEY = "store-clique/endpoints"

#: Reserved raw key carrying the CAS'd epoch'd shard map (live resharding).
#: Anchored on the *old* map's shard 0, mirrored to its successor and to the
#: new map's shard 0 — reachable from either side of a transition.
EPOCH_KEY = "store-clique/epoch"

#: keyspace-hash identity carried in every aggregated stats doc — a client
#: and a doc reader disagreeing on the hash would mis-attribute per-shard load
SHARD_HASH = "crc32"


def shard_of(key: str, nshards: int) -> int:
    """Deterministic key→shard index. ``crc32`` of the UTF-8 key: stable
    across processes, runs, and machines (``hash()`` is per-process salted
    and would scatter one job's clients across disagreeing maps)."""
    if nshards <= 1:
        return 0
    return zlib.crc32(key.encode("utf-8", "surrogatepass")) % nshards


def successor_of(shard: int, nshards: int) -> int:
    """The replica shard for a key whose primary is ``shard`` — the next
    shard on the hash ring. Degenerates to the primary itself at N=1, which
    is what makes 1-shard replication an exact no-op."""
    if nshards <= 1:
        return 0
    return (shard + 1) % nshards


def replicate_from_env() -> bool:
    return os.environ.get(REPLICATE_ENV, "").strip().lower() in ("1", "true", "on")


def parse_endpoints(spec: str) -> list[tuple[str, int]]:
    """``"host:port,host:port"`` → ``[(host, port), ...]`` (shard order)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port_s = part.rpartition(":")
        out.append((host or "127.0.0.1", int(port_s)))
    if not out:
        raise ValueError(f"no endpoints in shard spec {spec!r}")
    return out


def format_endpoints(endpoints: Iterable[tuple[str, int]]) -> str:
    return ",".join(f"{h}:{p}" for h, p in endpoints)


class ShardedKVClient:
    """Drop-in :class:`KVClient` over a store clique.

    Single-key ops route by :func:`shard_of`; prefix/scan/census ops fan out
    to every shard CONCURRENTLY (a small persistent pool, one worker per
    shard) and merge — shards hold disjoint keys, so the merged result is
    identical whichever shard answers first, and a serial fan-out was paying
    ``nshards`` sequential round trips on every reshard holder-gather and
    census (the PR-14 headroom note). Determinism is preserved: results
    merge in shard order, and when several shards fail the FIRST shard's
    error (by shard index) surfaces, after that shard's own retry budget and
    breaker — exactly the serial contract. Thread-safe to the same degree as
    ``KVClient`` (each underlying client locks its own persistent socket).
    """

    def __init__(
        self,
        endpoints: list[tuple[str, int]],
        timeout: float = 300.0,
        connect_retries: int = 60,
        auth_key: str | None = None,
        retry_budget: float = 8.0,
        replicate: bool | None = None,
    ):
        if not endpoints:
            raise ValueError("ShardedKVClient needs at least one endpoint")
        self.endpoints = [tuple(e) for e in endpoints]
        self.default_timeout = timeout
        self._connect_retries = connect_retries
        self._retry_budget = retry_budget
        #: successor replication (module doc): None defers to the launcher's
        #: $TPU_RESILIENCY_STORE_REPLICATE export.
        self._replicate = replicate_from_env() if replicate is None else bool(replicate)
        # HA bookkeeping: client-side failover tallies per failed shard
        # (folded into store_stats → merge_stats_docs so degraded-mode ops
        # land under the successor's row instead of vanishing), and the last
        # released generation per barrier name (the failover join's "already
        # released on the replica?" baseline).
        self._ha_lock = threading.Lock()
        self._failover_counts: dict[int, dict[str, int]] = {}
        self._barrier_gen: dict[str, int] = {}
        # Epoch'd shard map (live resharding): adopted lazily — probed only
        # when an op exhausts both primary and successor, never on a timer.
        self._epoch = 0
        self._epoch_checked_at = 0.0
        self._prev_client: Optional["ShardedKVClient"] = None
        # Set on clients built to speak a PREVIOUS map (dual-route window):
        # they must never adopt epochs themselves, or a write-through whose
        # old-map shard is dead chains prev→prev→prev adoption without bound.
        self._epoch_frozen = False
        # Per-shard clients are built LAZILY on first use: a clique client
        # must stay constructible while one shard is down (diagnostics
        # against a degraded clique, ops that never touch the dead shard).
        # The failure surfaces on the op that actually needs the shard —
        # after that shard's own connect ladder/breaker — and a later op
        # retries construction, so a restarted shard is picked up in place.
        self._shards: list[Optional[KVClient]] = [None] * len(self.endpoints)
        self._shards_lock = threading.Lock()
        self._fan_pool = None  # lazy; one worker per shard
        self._closed = False
        # Single-endpoint compatibility surface (diagnostics, logs).
        self.host, self.port = self.endpoints[0]
        if auth_key is None:
            auth_key = os.environ.get(AUTH_KEY_ENV) or None
        self.auth_key = auth_key

    @property
    def nshards(self) -> int:
        return len(self._shards)

    def _shard(self, i: int) -> KVClient:
        s = self._shards[i]
        if s is not None:
            return s
        with self._shards_lock:
            if self._closed:
                raise StoreError("store client is closed")
            s = self._shards[i]
            if s is None:
                h, p = self.endpoints[i]
                s = self._shards[i] = KVClient(
                    h, p, timeout=self.default_timeout,
                    connect_retries=self._connect_retries,
                    auth_key=self.auth_key, retry_budget=self._retry_budget,
                )
        return s

    def _for(self, key: str) -> KVClient:
        return self._shard(shard_of(key, len(self._shards)))

    def _live_shards(self) -> list[KVClient]:
        return [self._shard(i) for i in range(len(self.endpoints))]

    # -- HA routing (successor replication + failover) ---------------------

    def _route(self, key: str) -> tuple[int, int]:
        """(primary, successor) shard indices for ``key``. Successor equals
        primary when replication is off or the clique has one shard — every
        mirror/failover branch below keys off that equality."""
        n = len(self._shards)
        p = shard_of(key, n)
        if not self._replicate:
            return p, p
        return p, successor_of(p, n)

    def _emit_failover(self, shard: int, op: str, outcome: str) -> None:
        with self._ha_lock:
            per = self._failover_counts.setdefault(shard, {})
            per[outcome] = per.get(outcome, 0) + 1
        try:
            h, p = self.endpoints[shard]
            record_event(
                "store", "store_failover", shard=shard, op=op,
                outcome=outcome, endpoint=f"{h}:{p}",
                successor=successor_of(shard, len(self._shards)),
            )
        except Exception:
            pass

    def _breaker_tripped(self, shard: int) -> bool:
        h, p = self.endpoints[shard]
        return breaker_open(h, p)

    def _ha_read(self, key: str, op: str, fn):
        """Run ``fn(shard_client)`` against the key's primary, failing over
        to the successor replica on transport failure (or straight to it when
        the primary's breaker is already open). On total exhaustion, probe
        for a newer clique epoch once and retry on the adopted map."""
        for attempt in (0, 1):
            p, s = self._route(key)
            if s != p and self._breaker_tripped(p) and not self._breaker_tripped(s):
                self._emit_failover(p, op, "read")
                return fn(self._shard(s))
            try:
                return fn(self._shard(p))
            except StoreTransportError:
                if s != p:
                    self._emit_failover(p, op, "read")
                    try:
                        return fn(self._shard(s))
                    except StoreTransportError:
                        pass
                if attempt == 0 and self._maybe_adopt_epoch():
                    continue
                raise

    def _ha_write(self, key: str, op: str, fn):
        """Apply ``fn`` to the key's primary (successor failover on transport
        failure) and mirror it to the successor replica. ``fn`` runs as a
        fresh call per shard, so non-idempotent ops (``add``) get their own
        req_id against each shard's dedup LRU — the mirror is an independent
        dedup'd call, never a replayed frame."""
        for attempt in (0, 1):
            p, s = self._route(key)
            primary_dead = s != p and self._breaker_tripped(p) and not self._breaker_tripped(s)
            if not primary_dead:
                try:
                    r = fn(self._shard(p))
                except StoreTransportError:
                    primary_dead = s != p
                    if not primary_dead:
                        if attempt == 0 and self._maybe_adopt_epoch():
                            continue
                        raise
            if primary_dead:
                # The successor copy IS the write now; the primary picks the
                # key back up at the next epoch transition (reshard/replace).
                self._emit_failover(p, op, "mutate")
                try:
                    r = fn(self._shard(s))
                except StoreTransportError:
                    if attempt == 0 and self._maybe_adopt_epoch():
                        continue
                    raise
                self._write_through_prev(op, fn)
                return r
            if s != p:
                if self._breaker_tripped(s):
                    # Dead successor: skip the mirror outright instead of
                    # paying the retry ladder on every write until the
                    # breaker's next half-open probe.
                    self._emit_failover(s, op, "replica_skipped")
                else:
                    try:
                        fn(self._shard(s))
                    except StoreError:
                        # Replica temporarily behind: degrade the mirror,
                        # never the caller's (primary-acknowledged) write.
                        self._emit_failover(s, op, "replica_skipped")
            self._write_through_prev(op, fn)
            return r

    def _write_through_prev(self, op: str, fn) -> None:
        """Dual-route window (mid-reshard): a new-map write also lands on the
        previous map so pre-epoch clients keep reading fresh values until the
        transition settles. Contained — the old map may be half torn down."""
        prev = self._prev_client
        if prev is None:
            return
        try:
            fn(prev)
        except StoreError:
            pass

    def _prev_try_get(self, key: str, sentinel):
        """Dual-route read fallback: a key not yet migrated to the new map is
        still live on the previous one."""
        prev = self._prev_client
        if prev is None:
            return sentinel
        try:
            return prev.try_get(key, sentinel)
        except StoreError:
            return sentinel

    # -- epoch'd shard map (live resharding) -------------------------------

    def _epoch_anchors(self) -> list[int]:
        """Shard indices the epoch document is probed on: shard 0 and (when
        replicating) its successor — the two places a transition's author
        anchored it relative to *this* client's map."""
        n = len(self._shards)
        return [0] if (n == 1 or not self._replicate) else [0, successor_of(0, n)]

    def _read_epoch_doc(self) -> Optional[dict]:
        for i in self._epoch_anchors():
            try:
                doc = self._shard(i).try_get(EPOCH_KEY)
            except StoreError:
                continue
            if doc is not None:
                return doc
        return None

    def _maybe_adopt_epoch(self, min_interval: float = 1.0) -> bool:
        """Probe for a newer clique epoch and adopt it: rebuild the shard
        list, hold the previous map for dual-routing while the transition is
        unsettled (``prev`` present), drop it once settled. Called only from
        transport-failure exhaustion paths (rate-limited), so the healthy
        path never pays an epoch round trip. True ⇒ the caller should
        re-resolve routing and retry its op once.

        Fail-closed contract: a *malformed* epoch document (the clique moved
        to a map this client cannot parse) raises a descriptive
        :class:`StoreError`; an absent/unreachable document returns False and
        the caller re-raises its original transport error."""
        if self._epoch_frozen:
            return False
        now = time.monotonic()
        with self._ha_lock:
            if now - self._epoch_checked_at < min_interval:
                return False
            self._epoch_checked_at = now
        doc = self._read_epoch_doc()
        if doc is None:
            return False
        if not isinstance(doc, dict) or not isinstance(doc.get("epoch"), int) \
                or not doc.get("endpoints"):
            raise StoreError(
                f"clique epoch document under {EPOCH_KEY!r} is malformed "
                f"({doc!r}): the clique resharded to a map this client "
                f"cannot follow — reconnect via the launcher's current "
                f"shard spec"
            )
        settled = not doc.get("prev")
        with self._ha_lock:
            if doc["epoch"] < self._epoch or (
                doc["epoch"] == self._epoch
                and not (settled and self._prev_client is not None)
            ):
                return False
            new_eps = [tuple(e) for e in doc["endpoints"]]
            changed = new_eps != self.endpoints
            old_shards, old_pool = [], None
            if changed:
                old_shards, self._shards = self._shards, [None] * len(new_eps)
                old_pool, self._fan_pool = self._fan_pool, None
                old_prev, self._prev_client = self._prev_client, None
                self.endpoints = new_eps
                self.host, self.port = self.endpoints[0]
                if not settled:
                    # Dual-route window: keep one plain (non-replicating)
                    # client on the previous map for fallbacks/write-through.
                    self._prev_client = ShardedKVClient(
                        [tuple(e) for e in doc["prev"]],
                        timeout=self.default_timeout,
                        connect_retries=1, auth_key=self.auth_key,
                        retry_budget=0.0, replicate=False,
                    )
                    self._prev_client._epoch_frozen = True
            elif settled and self._prev_client is not None:
                old_prev, self._prev_client = self._prev_client, None
            else:
                old_prev = None
            self._epoch = doc["epoch"]
            if "replicate" in doc:
                self._replicate = bool(doc["replicate"])
        for c in [*old_shards, old_prev]:
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass
        if old_pool is not None:
            old_pool.shutdown(wait=False)
        record_event(
            "store", "shard_epoch", epoch=doc["epoch"],
            nshards=len(doc["endpoints"]),
            outcome="adopted" if changed else "settled",
        )
        log.info(
            f"adopted clique epoch {doc['epoch']}: "
            f"{format_endpoints(self.endpoints)}"
            + ("" if settled else " (dual-route window)")
        )
        return True

    def _fan_out(self, fn, contain: bool = False) -> list:
        """Run ``fn(shard_client)`` on every shard concurrently; results in
        shard order. With ``contain=False`` the lowest-indexed shard's
        exception propagates (the serial-era contract); ``contain=True``
        returns the exception object in that shard's slot instead (the
        stats path degrades rows, never the document)."""
        def run(i: int):
            # Shard construction happens INSIDE the task: a dead shard's
            # connect ladder neither blocks the other shards' ops nor (when
            # contained) escapes its own slot.
            return fn(self._shard(i))

        if len(self.endpoints) == 1:
            try:
                return [run(0)]
            except Exception as e:
                if contain:
                    return [e]
                raise
        with self._shards_lock:
            if self._fan_pool is None:
                if self._closed:
                    raise StoreError("store client is closed")
                import concurrent.futures as cf

                self._fan_pool = cf.ThreadPoolExecutor(
                    max_workers=len(self.endpoints),
                    thread_name_prefix="store-fan",
                )
            pool = self._fan_pool
        futs = [pool.submit(run, i) for i in range(len(self.endpoints))]
        results: list = []
        first_err: Optional[BaseException] = None
        for f in futs:
            try:
                results.append(f.result())
            except Exception as e:
                if contain:
                    results.append(e)
                else:
                    results.append(None)
                    if first_err is None:
                        first_err = e
        if first_err is not None:
            raise first_err
        return results

    def close(self) -> None:
        with self._shards_lock:
            self._closed = True
            shards, self._shards = self._shards, [None] * len(self.endpoints)
            pool, self._fan_pool = self._fan_pool, None
        prev, self._prev_client = self._prev_client, None
        if pool is not None:
            pool.shutdown(wait=False)
        for s in [*shards, prev]:
            if s is None:
                continue
            try:
                s.close()
            except Exception:
                pass

    # -- keyed ops (route by hash; replicated + failover per module doc) ---

    _MISS = object()  # dual-route miss sentinel

    def set(self, key: str, value: Any) -> None:
        self._ha_write(key, "set", lambda s: s.set(key, value))

    def get(self, key: str, timeout: float | None = None) -> Any:
        if self._prev_client is not None:
            # Dual-route window: a not-yet-migrated key would park the
            # blocking get on the new map while its value sits on the old.
            v = self._ha_read(
                key, "get", lambda s: s.try_get(key, self._MISS)
            )
            if v is self._MISS:
                v = self._prev_try_get(key, self._MISS)
            if v is not self._MISS:
                return v
        return self._ha_read(key, "get", lambda s: s.get(key, timeout))

    def try_get(self, key: str, default: Any = None) -> Any:
        v = self._ha_read(key, "try_get", lambda s: s.try_get(key, self._MISS))
        if v is self._MISS:
            v = self._prev_try_get(key, self._MISS)
        return default if v is self._MISS else v

    def delete(self, key: str) -> bool:
        return self._ha_write(key, "delete", lambda s: s.delete(key))

    def add(self, key: str, amount: int = 1) -> int:
        # Non-idempotent, but each shard call carries its own req_id against
        # that shard's dedup LRU — the mirror keeps the replica's total in
        # lockstep so a failover read of the counter is exact.
        return self._ha_write(key, "add", lambda s: s.add(key, amount))

    def compare_set(self, key: str, expected: Any, desired: Any) -> tuple[bool, Any]:
        # CAS linearizes on the primary; the replica converges via an
        # unconditional set of the winning value (losers don't mirror), so a
        # failed-over CAS chain resumes from (at worst) a recent committed
        # value and the state machine's own CAS semantics re-converge.
        for attempt in (0, 1):
            p, s = self._route(key)
            primary_dead = s != p and self._breaker_tripped(p) and not self._breaker_tripped(s)
            target = s if primary_dead else p
            if primary_dead:
                self._emit_failover(p, "cas", "mutate")
            try:
                ok, cur = self._shard(target).compare_set(key, expected, desired)
            except StoreTransportError:
                if not primary_dead and s != p:
                    self._emit_failover(p, "cas", "mutate")
                    try:
                        ok, cur = self._shard(s).compare_set(key, expected, desired)
                    except StoreTransportError:
                        if attempt == 0 and self._maybe_adopt_epoch():
                            continue
                        raise
                elif attempt == 0 and self._maybe_adopt_epoch():
                    continue
                else:
                    raise
            else:
                if ok and s != p and target == p:
                    if self._breaker_tripped(s):
                        self._emit_failover(s, "cas", "replica_skipped")
                    else:
                        try:
                            self._shard(s).set(key, desired)
                        except StoreError:
                            self._emit_failover(s, "cas", "replica_skipped")
            if ok:
                self._write_through_prev("cas", lambda c: c.set(key, desired))
            return ok, cur

    def get_versioned(self, key: str) -> tuple[Any, int]:
        return self._ha_read(key, "get_versioned", lambda s: s.get_versioned(key))

    def wait_changed(
        self, key: str, seen_version: int, timeout: float
    ) -> tuple[bool, Any, int]:
        # Watch-parks fail over too. Version clocks are per shard, so after
        # a failover the seen_version from the dead primary almost certainly
        # mismatches the replica's — the park wakes immediately (spurious but
        # safe: every caller re-reads state for truth on wake).
        return self._ha_read(
            key, "wait_changed", lambda s: s.wait_changed(key, seen_version, timeout)
        )

    def touch(self, key: str) -> None:
        self._ha_write(key, "touch", lambda s: s.touch(key))

    def list_append(self, key: str, value: Any) -> None:
        # Dedup'd per shard like add; both copies append once per call.
        self._ha_write(key, "list_append", lambda s: s.list_append(key, value))

    def list_get(self, key: str) -> list:
        return self._ha_read(key, "list_get", lambda s: s.list_get(key))

    def list_clear(self, key: str) -> None:
        self._ha_write(key, "list_clear", lambda s: s.list_clear(key))

    def set_add(self, key: str, values: Iterable) -> int:
        values = list(values)
        return self._ha_write(key, "set_add", lambda s: s.set_add(key, values))

    def set_get(self, key: str) -> set:
        return self._ha_read(key, "set_get", lambda s: s.set_get(key))

    def barrier_join(
        self,
        name: str,
        rank: int,
        world_size: int,
        timeout: float,
        wait: bool = True,
        on_behalf: bool = False,
    ) -> Optional[int]:
        # A barrier name hashes to ONE shard, so arrivals, parks, proxy joins
        # and the dedup of retried joins all stay on that shard's loop. With
        # replication, every arrival is FIRST mirrored to the successor as a
        # non-blocking join (idempotent re-registration server-side), so a
        # primary SIGKILLed mid-round leaves a complete arrival ledger on the
        # replica: stragglers fail over and the round releases there —
        # exactly once per joiner, because each client returns from exactly
        # one blocking join (primary or replica, never both).
        p, s = self._route(name)
        mirrored = False
        if s != p:
            if self._breaker_tripped(s) and not self._breaker_tripped(p):
                self._emit_failover(s, "barrier", "replica_skipped")
            else:
                try:
                    self._shard(s).barrier_join(
                        name, rank, world_size, timeout, wait=False,
                        on_behalf=on_behalf,
                    )
                    mirrored = True
                except StoreError:
                    self._emit_failover(s, "barrier", "replica_skipped")
        if not (s != p and self._breaker_tripped(p) and not self._breaker_tripped(s)):
            try:
                gen = self._shard(p).barrier_join(
                    name, rank, world_size, timeout, wait, on_behalf
                )
                if gen is not None:
                    with self._ha_lock:
                        self._barrier_gen[name] = gen
                return gen
            except StoreTransportError:
                if s == p:
                    raise
        self._emit_failover(p, "barrier", "barrier")
        return self._failover_barrier_join(
            s, name, rank, world_size, timeout, wait, on_behalf, mirrored
        )

    def _failover_barrier_join(
        self, s: int, name: str, rank: int, world_size: int,
        timeout: float, wait: bool, on_behalf: bool, mirrored: bool,
    ) -> Optional[int]:
        """Complete a barrier join on the successor after the primary died.

        Replica states, all resolved without double-firing or phantom rounds:
        the mirrored round already released there (generation advanced past
        our baseline, or our mirrored arrival was consumed by a release we
        never saw → return that generation); our mirror registration is
        still among the arrivals (only the release is missing → wait for the
        generation, NEVER re-join: a release racing the status read clears
        ``arrived``, and a blind re-join would then seed a phantom round and
        park forever); or the mirror was skipped (plain join, with "joined
        twice" overflow downgraded to a release wait)."""
        with self._ha_lock:
            base = self._barrier_gen.get(name)
        c = self._shard(s)
        st = c.barrier_status(name)
        gen = (st or {}).get("generation", 0)
        arrived = (st or {}).get("arrived") or ()
        if base is not None and gen > base:
            with self._ha_lock:
                self._barrier_gen[name] = gen
            return gen if wait else None
        if mirrored and st is not None:
            if rank in arrived:
                # The mirror IS our arrival; it only lacks the release.
                if not wait:
                    return None
                return self._await_barrier_release(c, name, gen, timeout)
            if gen > (base or 0):
                # Not among the arrivals and the generation moved: the
                # release that cleared us is the one that counted us.
                with self._ha_lock:
                    self._barrier_gen[name] = gen
                return gen if wait else None
            # Anomalous (registration vanished with no release — e.g. a
            # barrier_del raced us): fall through to a real join.
        try:
            gen = c.barrier_join(name, rank, world_size, timeout, wait, on_behalf)
            if gen is not None:
                with self._ha_lock:
                    self._barrier_gen[name] = gen
            return gen
        except BarrierOverflow:
            # "Joined twice": our arrival is already on the books.
            if not wait:
                return None
            return self._await_barrier_release(c, name, gen, timeout)

    def _await_barrier_release(
        self, c: KVClient, name: str, base: int, timeout: float
    ) -> int:
        """Wait for barrier ``name``'s generation to advance past ``base`` on
        shard client ``c`` — the already-arrived half of a blocking join."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            st = c.barrier_status(name)
            gen = (st or {}).get("generation", 0)
            if gen > base:
                with self._ha_lock:
                    self._barrier_gen[name] = gen
                return gen
            if time.monotonic() >= deadline:
                raise BarrierTimeout(
                    f"failover barrier wait timed out on successor: {name}"
                )
            time.sleep(0.05)

    def barrier_status(self, name: str) -> Optional[dict]:
        return self._ha_read(name, "barrier_status", lambda s: s.barrier_status(name))

    def barrier_del(self, name: str) -> bool:
        return self._ha_write(name, "barrier_del", lambda s: s.barrier_del(name))

    # -- fan-out ops (merge across shards) ---------------------------------

    def _fan_out_ha(self, op: str, fn) -> list:
        """Fan out with dead-shard absorption: when replicating, a shard
        that fails on transport is dropped from the merge *iff* its successor
        answered — the successor's slot holds the dead shard's replicated
        keyspace, so the merged result is still complete. Results arrive in
        shard order with absorbed slots as ``None``."""
        n = len(self.endpoints)
        if not self._replicate or n == 1:
            return self._fan_out(fn)
        results = self._fan_out(fn, contain=True)
        first_err: Optional[BaseException] = None
        out: list = []
        for i, r in enumerate(results):
            if isinstance(r, BaseException):
                succ = successor_of(i, n)
                if isinstance(r, StoreTransportError) and not isinstance(
                    results[succ], BaseException
                ):
                    self._emit_failover(i, op, "absorbed")
                    out.append(None)
                    continue
                if first_err is None:
                    first_err = r
                out.append(None)
                continue
            out.append(r)
        if first_err is not None:
            raise first_err
        return out

    def _merge_keyed(self, op: str, fn) -> dict:
        """Merge dict-shaped fan-out results. Under replication a key exists
        on two shards; the primary's copy wins (the replica may be one
        skipped mirror behind), and absorbed shards contribute through their
        successor's slot."""
        parts = self._fan_out_ha(op, fn)
        n = len(self.endpoints)
        if not self._replicate or n == 1:
            out: dict = {}
            for part in parts:
                out.update(part)  # shards hold disjoint keys
            return out
        out = {}
        for i, part in enumerate(parts):
            if part is None:
                continue
            for k, v in part.items():
                if shard_of(k, n) == i:
                    out[k] = v  # primary copy is authoritative
                else:
                    out.setdefault(k, v)
        return out

    def ping(self) -> bool:
        return all(self._fan_out(lambda s: s.ping()))

    def check(self, keys: Iterable[str]) -> bool:
        by_shard: dict[int, list[str]] = {}
        for k in keys:
            by_shard.setdefault(shard_of(k, len(self._shards)), []).append(k)
        if not by_shard:
            return True
        import concurrent.futures as cf

        def check_batch(i: int, ks: list[str]) -> bool:
            try:
                return self._shard(i).check(ks)
            except StoreTransportError:
                succ = successor_of(i, len(self._shards))
                if succ == i or not self._replicate:
                    raise
                self._emit_failover(i, "check", "read")
                return self._shard(succ).check(ks)

        if len(by_shard) == 1:
            ((i, ks),) = by_shard.items()
            return check_batch(i, ks)
        with cf.ThreadPoolExecutor(max_workers=len(by_shard)) as pool:
            futs = [
                pool.submit(check_batch, i, ks)
                for i, ks in sorted(by_shard.items())
            ]
            return all(f.result() for f in futs)

    def prefix_get(self, prefix: str) -> dict[str, Any]:
        out = self._merge_keyed("prefix_get", lambda s: s.prefix_get(prefix))
        prev = self._prev_client
        if prev is not None:
            try:
                for k, v in prev.prefix_get(prefix).items():
                    out.setdefault(k, v)  # not-yet-migrated keys
            except StoreError:
                pass
        return out

    def prefix_clear(self, prefix: str) -> int:
        # Replicas live under the same names, so the all-shards fan-out
        # clears both copies; the count under replication is copies removed.
        n = sum(
            r for r in self._fan_out_ha(
                "prefix_clear", lambda s: s.prefix_clear(prefix)
            ) if r is not None
        )
        self._write_through_prev("prefix_clear", lambda c: c.prefix_clear(prefix))
        return n

    def stale_keys(self, prefix: str, max_age: float) -> dict[str, float]:
        return self._merge_keyed(
            "stale_keys", lambda s: s.stale_keys(prefix, max_age)
        )

    def num_keys(self) -> int:
        if self._replicate and len(self.endpoints) > 1:
            return len(self.keys())  # replicas would double-count
        return sum(self._fan_out(lambda s: s.num_keys()))

    def keys(self, prefix: str = "") -> list[str]:
        out: set[str] = set()
        for part in self._fan_out_ha("keys", lambda s: s.keys(prefix)):
            if part is not None:
                out.update(part)  # replicas dedupe by name
        return sorted(out)

    def barrier_names(self) -> list[str]:
        out: set[str] = set()
        for part in self._fan_out_ha("barrier_names", lambda s: s.barrier_names()):
            if part is not None:
                out.update(part)
        return sorted(out)

    def barrier_census(self, prefix: str = "") -> dict[str, dict]:
        return self._merge_keyed(
            "barrier_census", lambda s: s.barrier_census(prefix)
        )

    def store_stats(self) -> dict:
        """One aggregated ``tpu-store-stats-1`` document for the whole clique
        (op/byte/conn totals summed, quantiles worst-shard — see
        :func:`tpu_resiliency_torch.utils.opstats.merge_stats_docs`), with the shard
        map and a per-shard summary table folded in. A single-shard clique
        returns the shard's own document plus the (degenerate) shard map, so
        readers see one schema either way."""
        from tpu_resiliency_torch.utils.opstats import merge_stats_docs

        def one(s: KVClient) -> dict:
            try:
                return s.store_stats()
            except StoreError as e:
                # One sick shard degrades its row, never the whole document.
                return {"enabled": False, "error": repr(e)}

        docs = []
        for (h, p), doc in zip(self.endpoints, self._fan_out(one, contain=True)):
            if isinstance(doc, BaseException):
                doc = {"enabled": False, "error": repr(doc)}
            doc["endpoint"] = f"{h}:{p}"
            docs.append(doc)
        n = len(self._shards)
        with self._ha_lock:
            failover_ops = {
                i: sum(per.values()) for i, per in self._failover_counts.items()
            }
        merged = merge_stats_docs(
            docs,
            successor_map={i: successor_of(i, n) for i in range(n)}
            if self._replicate else None,
            failover_ops=failover_ops or None,
        )
        merged["shard_map"] = {
            "nshards": n,
            "hash": SHARD_HASH,
            "endpoints": [f"{h}:{p}" for h, p in self.endpoints],
            "replicate": self._replicate,
            "epoch": self._epoch,
        }
        return merged


class CliqueStore(StoreView):
    """A :class:`StoreView` that owns a :class:`ShardedKVClient` — the
    sharded sibling of :class:`~tpu_resiliency_torch.platform.store.CoordStore`."""

    def __init__(
        self,
        endpoints: list[tuple[str, int]],
        prefix: str = "",
        timeout: float = 300.0,
        connect_retries: int = 60,
        auth_key: str | None = None,
        retry_budget: float = 8.0,
        replicate: bool | None = None,
    ):
        client = ShardedKVClient(
            endpoints, timeout=timeout, connect_retries=connect_retries,
            auth_key=auth_key, retry_budget=retry_budget, replicate=replicate,
        )
        super().__init__(client, prefix)

    def close(self) -> None:
        self.client.close()


def reshard_clique(
    client: ShardedKVClient,
    new_endpoints,
    *,
    settle: bool = True,
    scan_prefix: str = "",
) -> dict:
    """Transition a live clique to a new shard map — grow, shrink, or replace
    a dead shard with a fresh :class:`KVServer` — without a barrier ever
    failing. The epoch protocol, in order:

    1. **Publish** the next epoch document (CAS on the old map's shard 0,
       raw :data:`EPOCH_KEY`; mirrored by plain set to the old shard 0's
       successor and the new map's shard 0) with ``prev`` set — the
       dual-route window opens. ``client`` adopts it immediately.
    2. **Migrate** the value keyspace by concurrent prefix scan of the old
       map's reachable shards (a dead shard's keyspace comes from its
       successor replica — that's what replication bought), rewriting every
       key through the new map's routing (primary + successor). Coordination
       state that is round-scoped (barriers, lists/sets in flight) is not
       copied: during the window those ops stay on the old map, and rounds
       opened after settle live natively on the new map.
    3. **Settle** (``prev: None``): dual-routing ends; old-map clients that
       lose a shard after this adopt the new map on their next failure.
       Republish :data:`CLIQUE_KEY` on the new shard 0 so late joiners probe
       straight into the new map.

    Returns the settled (or migrating, with ``settle=False``) epoch doc with
    a ``migrated`` key count folded in. The caller owns the new servers'
    lifecycle; with ``settle=False`` the caller finishes by calling this
    again with the same endpoints (idempotent: same-epoch settle)."""
    new_eps = [
        tuple(e) for e in (
            parse_endpoints(new_endpoints)
            if isinstance(new_endpoints, str) else new_endpoints
        )
    ]
    if not new_eps:
        raise ValueError("reshard_clique needs at least one endpoint")
    cur = client._read_epoch_doc()
    cur_epoch = cur["epoch"] if isinstance(cur, dict) else 0
    old_eps = list(client.endpoints)
    resuming = (
        isinstance(cur, dict) and cur.get("prev")
        and [list(e) for e in new_eps] == cur.get("endpoints")
    )
    if resuming:
        # Finishing a window opened by an earlier ``settle=False`` pass:
        # same epoch, same endpoints — re-migrate and settle, don't chain a
        # fresh epoch.
        doc = {k: cur[k] for k in ("epoch", "endpoints", "prev", "replicate")
               if k in cur}
        old_eps = [tuple(e) for e in cur["prev"]]
    else:
        doc = {
            "epoch": cur_epoch + 1,
            "endpoints": [list(e) for e in new_eps],
            "prev": [list(e) for e in old_eps],
            "replicate": client._replicate,
        }

    def direct(ep) -> KVClient:
        return KVClient(
            ep[0], ep[1], timeout=10.0, connect_retries=1,
            auth_key=client.auth_key, retry_budget=0.0,
        )

    def publish(d: dict, expected) -> None:
        # CAS anchor: the OLD map's shard 0 (concurrent-reshard detection
        # lives where every pre-transition client can see it). When that
        # shard is the casualty being replaced, fall through to the new
        # map's shard 0 — a recovery write, force-set when the new anchor
        # never saw the chain. Mirrors (plain set) land everywhere any
        # client's epoch probe looks: old successor-of-0, new shard 0, new
        # successor-of-0.
        anchors = [old_eps[0]]
        if tuple(new_eps[0]) != tuple(old_eps[0]):
            anchors.append(new_eps[0])
        published = False
        last_err: Optional[BaseException] = None
        for ai, ep in enumerate(anchors):
            try:
                a = direct(ep)
                try:
                    ok, now_cur = a.compare_set(EPOCH_KEY, expected, d)
                    if not ok and now_cur == d:
                        ok = True  # idempotent republish (retried settle)
                    if not ok and ai > 0 and (
                        now_cur is None
                        or (isinstance(now_cur, dict)
                            and now_cur.get("epoch", 0) < d["epoch"])
                    ):
                        a.set(EPOCH_KEY, d)  # new anchor never saw the chain
                        ok = True
                    if not ok:
                        raise StoreError(
                            f"concurrent reshard detected (epoch key moved "
                            f"to {now_cur!r})"
                        )
                finally:
                    a.close()
                published = True
                break
            except StoreTransportError as e:
                last_err = e
        if not published:
            raise StoreError(
                f"reshard could not publish epoch {d['epoch']}: no anchor "
                f"shard reachable"
            ) from last_err
        mirrors: list[tuple[str, int]] = []
        for ep in (
            old_eps[successor_of(0, len(old_eps))] if len(old_eps) > 1 else None,
            new_eps[0],
            new_eps[successor_of(0, len(new_eps))] if len(new_eps) > 1 else None,
        ):
            if ep is not None and tuple(ep) != tuple(old_eps[0]) \
                    and tuple(ep) not in mirrors:
                mirrors.append(tuple(ep))
        for ep in mirrors:
            try:
                m = direct(ep)
                try:
                    m.set(EPOCH_KEY, d)
                finally:
                    m.close()
            except StoreError:
                pass

    publish(doc, cur)
    record_event(
        "store", "shard_epoch", epoch=doc["epoch"], nshards=len(new_eps),
        outcome="migrating", prev_nshards=len(old_eps),
    )
    client._maybe_adopt_epoch(min_interval=0.0)
    # Migrate through the adopted client: its prefix_get absorbs a dead old
    # shard via the successor replica, and its set() writes land replicated
    # on the new map AND write-through to the old primary (dual-route).
    snapshot = client.prefix_get(scan_prefix)
    migrated = 0
    for k, v in snapshot.items():
        if k == EPOCH_KEY or k == CLIQUE_KEY:
            continue
        client.set(k, v)
        migrated += 1
    if settle:
        settled = dict(doc)
        settled["prev"] = None
        publish(settled, doc)
        try:
            c0 = KVClient(
                *new_eps[0], timeout=10.0, connect_retries=1,
                auth_key=client.auth_key, retry_budget=0.0,
            )
            try:
                c0.set(CLIQUE_KEY, format_endpoints(new_eps))
            finally:
                c0.close()
        except StoreError:
            pass
        record_event(
            "store", "shard_epoch", epoch=doc["epoch"], nshards=len(new_eps),
            outcome="settled", migrated=migrated,
        )
        client._maybe_adopt_epoch(min_interval=0.0)
        doc = settled
    out = dict(doc)
    out["migrated"] = migrated
    return out


def endpoints_from_env() -> Optional[list[tuple[str, int]]]:
    """The clique advertised by ``$TPU_RESILIENCY_STORE_SHARDS`` (the
    launcher's export), or ``None`` when unset/single-endpoint-classic."""
    spec = os.environ.get(SHARDS_ENV, "").strip()
    if not spec:
        return None
    return parse_endpoints(spec)


def connect_store(
    host: str,
    port: int,
    prefix: str = "",
    *,
    shards: str = "",
    timeout: float = 300.0,
    connect_retries: int = 60,
    auth_key: str | None = None,
    retry_budget: float = 8.0,
    replicate: bool | None = None,
):
    """Store-client factory every plane shares: a ``shards`` spec (argument,
    else ``$TPU_RESILIENCY_STORE_SHARDS``) yields a :class:`CliqueStore`;
    otherwise the classic single-endpoint
    :class:`~tpu_resiliency_torch.platform.store.CoordStore`. Components that take
    ``(host, port)`` today migrate by calling this instead of the
    constructor — no signature churn. ``replicate=None`` defers to the
    launcher's ``$TPU_RESILIENCY_STORE_REPLICATE`` export."""
    from tpu_resiliency_torch.platform.store import CoordStore

    eps = parse_endpoints(shards) if shards else endpoints_from_env()
    if eps and len(eps) > 1:
        return CliqueStore(
            eps, prefix=prefix, timeout=timeout,
            connect_retries=connect_retries, auth_key=auth_key,
            retry_budget=retry_budget, replicate=replicate,
        )
    if eps:  # single-shard clique spec: classic layout at that endpoint
        host, port = eps[0]
    return CoordStore(
        host, port, prefix=prefix, timeout=timeout,
        connect_retries=connect_retries, auth_key=auth_key,
        retry_budget=retry_budget,
    )


def probe_clique_spec(
    host: str, port: int, auth_key: str | None = None, timeout: float = 2.0
) -> str:
    """One cheap round trip against a live endpoint: the clique spec its
    spawner published under :data:`CLIQUE_KEY`, or ``""`` (plain store,
    pre-shard server, or any failure — callers fall back to classic mode)."""
    try:
        c = KVClient(
            host, port, timeout=timeout, connect_retries=1,
            auth_key=auth_key, retry_budget=0.0,
        )
    except StoreError:
        return ""
    try:
        spec = c.try_get(CLIQUE_KEY, "")
        return spec if isinstance(spec, str) else ""
    except StoreError:
        return ""
    finally:
        c.close()


class LocalClique:
    """N in-process :class:`KVServer` loops — the test/chaos harness shape
    (each server still owns its own selector thread and state; only the
    bench's subprocess clique buys real per-core parallelism)."""

    def __init__(self, nshards: int, host: str = "127.0.0.1", **server_kw):
        self.servers = [
            KVServer(host=host, port=0, **server_kw) for _ in range(nshards)
        ]
        self.endpoints = [(host, s.port) for s in self.servers]

    @property
    def spec(self) -> str:
        return format_endpoints(self.endpoints)

    def client(self, prefix: str = "", **kw) -> CliqueStore:
        return CliqueStore(self.endpoints, prefix=prefix, **kw)

    def close(self) -> None:
        for s in self.servers:
            try:
                s.close()
            except Exception:
                pass


class SpawnedClique:
    """N ``KVServer`` *processes* (``python -m tpu_resiliency_torch.platform.store``)
    — the deployment shape: each shard's event loop owns a core. Used by the
    launcher's ``--store-shards`` and the scale bench. Shard 0 may bind a
    fixed port (the job's rendezvous endpoint); the rest take ephemeral ports
    read back from the child's banner line."""

    def __init__(
        self,
        nshards: int,
        host: str = "127.0.0.1",
        first_port: int = 0,
        spawn_timeout: float = 20.0,
        advertise_host: str | None = None,
    ):
        # ``host`` is the BIND address (0.0.0.0 for authenticated multi-host
        # cliques); ``advertise_host`` is what lands in the published spec —
        # the address peers dial. Liveness probes always go over loopback
        # (we spawned the children on this machine).
        self.procs: list[subprocess.Popen] = []
        self.endpoints: list[tuple[str, int]] = []
        adv = advertise_host or ("127.0.0.1" if host in ("127.0.0.1", "") else host)
        if adv == "0.0.0.0":
            adv = "127.0.0.1"
        env = dict(os.environ)
        try:
            for i in range(nshards):
                port = first_port if i == 0 else 0
                p = subprocess.Popen(
                    [sys.executable, "-m", "tpu_resiliency_torch.platform.store",
                     f"{host}:{port}"],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                    text=True, env=env,
                )
                self.procs.append(p)
                banner = p.stdout.readline().strip()
                # "store serving on HOST:PORT"
                try:
                    bound = int(banner.rsplit(":", 1)[1])
                except (IndexError, ValueError):
                    raise StoreError(
                        f"store shard {i} failed to start (banner {banner!r})"
                    )
                self.endpoints.append((adv, bound))
            deadline = time.monotonic() + spawn_timeout
            for _, bound in self.endpoints:
                while not store_answers("127.0.0.1", bound, timeout=1.0):
                    if time.monotonic() >= deadline:
                        raise StoreError(
                            f"store shard 127.0.0.1:{bound} never answered ping"
                        )
                    time.sleep(0.05)
        except BaseException:
            self.close()
            raise

    @property
    def spec(self) -> str:
        return format_endpoints(self.endpoints)

    @property
    def port(self) -> int:
        return self.endpoints[0][1]

    def client(self, prefix: str = "", **kw) -> CliqueStore:
        return CliqueStore(self.endpoints, prefix=prefix, **kw)

    def close(self, join: bool = True, timeout: float = 5.0) -> None:
        for p in self.procs:
            try:
                p.terminate()
            except OSError:
                pass
        if join:
            for p in self.procs:
                try:
                    p.wait(timeout)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout)

    def respawn_shard(self, shard: int, spawn_timeout: float = 20.0) -> tuple[str, int]:
        """Replace one (dead) shard process with a fresh ``KVServer`` on an
        ephemeral port; returns the new endpoint. The caller still owns the
        epoch transition — pair with :func:`reshard_clique` to route the
        keyspace onto the replacement."""
        old = self.procs[shard]
        try:
            if old.poll() is None:
                old.terminate()
            old.wait(spawn_timeout)
        except (OSError, subprocess.TimeoutExpired):
            try:
                old.kill()
            except OSError:
                pass
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_resiliency_torch.platform.store",
             "127.0.0.1:0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=dict(os.environ),
        )
        banner = p.stdout.readline().strip()
        try:
            bound = int(banner.rsplit(":", 1)[1])
        except (IndexError, ValueError):
            p.kill()
            raise StoreError(
                f"replacement for shard {shard} failed to start "
                f"(banner {banner!r})"
            )
        deadline = time.monotonic() + spawn_timeout
        while not store_answers("127.0.0.1", bound, timeout=1.0):
            if time.monotonic() >= deadline:
                p.kill()
                raise StoreError(
                    f"replacement shard 127.0.0.1:{bound} never answered ping"
                )
            time.sleep(0.05)
        adv = self.endpoints[shard][0]
        self.procs[shard] = p
        self.endpoints[shard] = (adv, bound)
        return (adv, bound)


class AutoReshardSupervisor:
    """Automatic shard respawn: the launcher-side watcher that turns the
    operator runbook (notice a dead shard, spawn a replacement, run
    ``reshard_clique``) into a closed loop.

    Polls each shard of a job-hosted :class:`SpawnedClique` — a shard is a
    respawn candidate when its *process* has exited or its client-side
    circuit breaker is open AND a direct liveness probe fails (the breaker
    alone can reflect a transient blip; the probe confirms the shard is
    really gone). A candidate that stays dead past ``grace`` seconds is
    replaced: :meth:`SpawnedClique.respawn_shard` spawns the new server and
    :func:`reshard_clique` migrates the keyspace onto the healed map. Every
    attempt is audited as a ``store_auto_reshard`` event
    (``outcome=ok|failed``); the operator-initiated path is untouched."""

    def __init__(
        self,
        clique: SpawnedClique,
        client: ShardedKVClient,
        *,
        interval: float = 1.0,
        grace: float = 3.0,
    ):
        self.clique = clique
        self.client = client
        self.interval = interval
        self.grace = grace
        self._dead_since: dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: successful automatic reshards (observable for tests/telemetry)
        self.reshards = 0

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="store-auto-reshard"
            )
            self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception as e:  # supervision must outlive any one probe
                log.warning(f"store auto-reshard tick failed: {e!r}")

    def _shard_dead(self, shard: int) -> bool:
        if self.clique.procs[shard].poll() is not None:
            return True
        host, port = self.clique.endpoints[shard]
        if not breaker_open(host, port):
            return False
        return not store_answers("127.0.0.1", port, timeout=1.0)

    def _tick(self) -> None:
        now = time.monotonic()
        for shard in range(len(self.clique.endpoints)):
            if not self._shard_dead(shard):
                self._dead_since.pop(shard, None)
                continue
            since = self._dead_since.setdefault(shard, now)
            if now - since < self.grace:
                continue
            self._respawn(shard)
            self._dead_since.pop(shard, None)

    def _respawn(self, shard: int) -> None:
        old = self.clique.endpoints[shard]
        try:
            new_ep = self.clique.respawn_shard(shard)
            doc = reshard_clique(self.client, list(self.clique.endpoints))
        except (StoreError, OSError) as e:
            log.warning(
                f"store auto-reshard of shard {shard} "
                f"({old[0]}:{old[1]}) failed: {e!r}"
            )
            record_event(
                "store", "store_auto_reshard", shard=shard,
                old=f"{old[0]}:{old[1]}", outcome="failed", error=repr(e),
            )
            return
        self.reshards += 1
        log.info(
            f"store auto-reshard: shard {shard} {old[0]}:{old[1]} -> "
            f"{new_ep[0]}:{new_ep[1]} (epoch {doc.get('epoch')})"
        )
        record_event(
            "store", "store_auto_reshard", shard=shard,
            old=f"{old[0]}:{old[1]}", new=f"{new_ep[0]}:{new_ep[1]}",
            epoch=doc.get("epoch"), outcome="ok",
        )
