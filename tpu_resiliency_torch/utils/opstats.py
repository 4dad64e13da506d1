"""Lock-cheap per-operation accounting for the coordination store.

``platform/store.py`` is the plane every subsystem leans on — rendezvous,
barriers, metrics push, reshard holder-gather all ride it — and until this
module it exported zero self-telemetry: proving "the store is slow" meant
strace. :class:`OpStats` is the collector the store's event loop feeds inline:
per-op latency histograms split into **queue wait** (bytes on the socket →
dispatch) and **handle time** (the dispatch itself, parks excluded), bytes
in/out, live/peak connection counts, the request-dedup LRU hit rate, and a
top-K hot-key-prefix table kept by a space-saving sketch — bounded memory, no
unbounded per-key dict, no locks (the single loop thread owns every mutation;
``snapshot()`` reads are torn-tolerant by design, the way the loop's other
introspection ops already are).

Surfaces (see ``docs/observability.md``):

- the idempotent ``store_stats`` wire op → the ``tpu-store-stats-1`` document
  (:meth:`OpStats.snapshot` + the server's live conn/park counts);
- ``GET /storez`` on the launcher's :class:`TelemetryServer` (schema
  ``tpu-storez-1``), folded into ``/snapshot`` so fleetd gets it for free;
- periodic ``store_stats`` *events* carrying per-op deltas
  (:meth:`OpStats.take_deltas`) → ``tpu_store_ops_total{op}``,
  ``tpu_store_op_seconds{op}``, ``tpu_store_bytes_total{direction}``,
  ``tpu_store_conns`` through ``observe_record``, so the live Prometheus view
  and a post-hoc aggregation of the same stream agree;
- ``tpu-store-info ENDPOINT --stats`` renders the live document.

A broken collector must never break the op path: the store calls every method
through a containment shim that disables stats (and degrades the document to
an ``error`` field) on the first exception.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Iterable, Optional

SCHEMA = "tpu-store-stats-1"

#: Latency bucket upper bounds (seconds) tuned for an in-memory event-loop
#: store: dict-op dispatch is microseconds, a loaded loop's queue wait is
#: tens of microseconds to milliseconds, and anything beyond a second means
#: the loop is wedged behind something it should never be behind.
LATENCY_BOUNDS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 5.0, 30.0,
)


class LatencyHist:
    """Fixed-bound bucket histogram: O(log buckets) observe, O(buckets) read.

    No reservoir, no lock — this runs inside the store's event loop where
    every nanosecond is tax on every op. Quantiles are bucket-interpolated
    (the Prometheus ``histogram_quantile`` estimate), which is exactly enough
    resolution to answer "p95 handle time by op"."""

    __slots__ = ("bounds", "counts", "count", "sum", "max")

    def __init__(self, bounds: Iterable[float] = LATENCY_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +Inf tail
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = v if v > 0.0 else 0.0
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Linear-interpolated bucket quantile; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - cum) / n
                return lo + (hi - lo) * frac
            cum += n
        return self.max

    def doc(self) -> dict:
        return {
            "count": self.count,
            "sum_s": round(self.sum, 9),
            "p50_us": round(self.quantile(0.50) * 1e6, 3),
            "p95_us": round(self.quantile(0.95) * 1e6, 3),
            "p99_us": round(self.quantile(0.99) * 1e6, 3),
            "max_us": round(self.max * 1e6, 3),
        }


class SpaceSaving:
    """Misra-Gries / space-saving top-K frequency sketch.

    Tracks at most ``k`` keys; an unseen key evicts the current minimum and
    inherits its count as over-estimation ``err``. Every reported count is
    within ``err`` of the true count, and any key with true frequency above
    ``total/k`` is guaranteed present — exactly the guarantee a hot-key table
    needs, at k dict entries instead of one per key ever touched."""

    __slots__ = ("k", "counts", "errors", "total")

    def __init__(self, k: int = 32):
        self.k = k
        self.counts: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.total = 0

    def add(self, key: str, weight: int = 1) -> None:
        self.total += weight
        counts = self.counts
        if key in counts:
            counts[key] += weight
            return
        if len(counts) < self.k:
            counts[key] = weight
            self.errors[key] = 0
            return
        victim = min(counts, key=counts.__getitem__)
        floor = counts.pop(victim)
        self.errors.pop(victim, None)
        counts[key] = floor + weight
        self.errors[key] = floor

    def items(self, top: Optional[int] = None) -> list[dict]:
        ranked = sorted(self.counts.items(), key=lambda kv: -kv[1])
        if top is not None:
            ranked = ranked[:top]
        return [
            {"prefix": key, "count": n, "err": self.errors.get(key, 0)}
            for key, n in ranked
        ]


def key_prefix(key: str, depth: int = 2) -> str:
    """The first ``depth`` path segments of a store key — the granularity the
    hot-prefix table aggregates at (``jobmetrics/<rdzv-id>``, not every
    per-incarnation leaf key)."""
    parts = key.split("/")
    return "/".join(parts[:depth]) if len(parts) > depth else key


class OpStats:
    """Per-op accounting fed by the store's single loop thread.

    Not thread-safe on purpose: the owner is the event loop, and a lock here
    would be pure tax on every op. Cross-thread readers (none today — the
    ``store_stats`` op runs on the loop) would at worst see a torn-but-valid
    snapshot."""

    #: 1-in-N sampling for the WHOLE collector: the server calls
    #: :meth:`note_op` for one op in SAMPLE and pays a single counter
    #: decrement for the rest — no clock read, no dict traffic. Every tally
    #: (count, errors, bytes) is scaled by SAMPLE back into op/byte units,
    #: so the documents read naturally but carry ±SAMPLE granularity: a hot
    #: op's figures are statistically exact, an op called twice ever may
    #: show 0 or 16 (one sample's weight). That trade is deliberate — exact per-op accounting was
    #: measured at 2-4 µs/op of py3.10 attribute traffic in situ, >5% of a
    #: ~35 µs loopback op (scripts/bench_store.py's overhead leg is the
    #: regression gate), and the rare-op forensics live elsewhere anyway
    #: (``barrier_census``, the exact live conn/park counts in the doc).
    SAMPLE = 16

    def __init__(self, top_k: int = 32):
        self.started_at = time.time()
        #: op -> [count, errors, bytes_in], sampled-scaled (op/byte units,
        #: ±SAMPLE granularity — see :data:`SAMPLE`)
        self.rows: dict[Any, list] = {}
        self._handle: dict[str, LatencyHist] = {}
        self._wait: dict[str, LatencyHist] = {}
        self.bytes_out = 0
        self.conns_total = 0
        self.conns_peak = 0
        self.dedup_hits = 0
        self.dedup_lookups = 0
        self.hot = SpaceSaving(top_k)
        #: per-counter values already reported by :meth:`take_deltas`
        self._published: dict[str, Any] = {
            "ops": {}, "op_seconds": {}, "bytes_in": 0, "bytes_out": 0,
        }

    # -- ingest (loop thread) ----------------------------------------------

    def note_conn(self, live: int) -> None:
        self.conns_total += 1
        if live > self.conns_peak:
            self.conns_peak = live

    def note_dedup(self, hit: bool) -> None:
        self.dedup_lookups += 1
        if hit:
            self.dedup_hits += 1

    def row_for(self, op) -> list:
        """Create-or-get the tally row for ``op`` (sampled-scaled
        [count, errors, bytes_in] — see :data:`SAMPLE`)."""
        if not isinstance(op, str):
            op = str(op)
        row = self.rows.get(op)
        if row is None:
            row = self.rows[op] = [0, 0, 0]
            self._handle[op] = LatencyHist()
            self._wait[op] = LatencyHist()
        return row

    def note_op(
        self,
        op: str,
        wait_s: float,
        handle_s: float,
        bytes_in: int,
        req: Optional[dict] = None,
        error: bool = False,
    ) -> None:
        """The SAMPLED arm — called for 1 op in :data:`SAMPLE`, so every
        tally is scaled by :data:`SAMPLE` to stay in op/byte units. Latency
        histograms and the hot-prefix sketch ride the same sample."""
        if not isinstance(op, str):
            op = str(op)
        row = self.rows.get(op)
        if row is None:
            row = self.row_for(op)
        row[0] += self.SAMPLE
        if error:
            row[1] += self.SAMPLE
        row[2] += bytes_in * self.SAMPLE
        self._handle[op].observe(handle_s)
        if wait_s >= 0.0:
            self._wait[op].observe(wait_s)
        if req is not None:
            key = req.get("key") or req.get("prefix") or req.get("name")
            if key:
                self.hot.add(key_prefix(str(key)), self.SAMPLE)

    @property
    def bytes_in(self) -> int:
        # Summed at read time, not accumulated per op — one fewer write on
        # the hot path; per-op rows already carry the exact figure.
        return sum(row[2] for row in self.rows.values())

    # -- read --------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``tpu-store-stats-1`` document body (the server adds its live
        conn/park/table counts on top)."""
        ops = {}
        for op in sorted(self.rows, key=str):
            count, errors, b_in = self.rows[op]
            ops[op] = {
                "count": count,
                "errors": errors,
                "bytes_in": b_in,
                # Sampled-scaled estimate of total handle seconds (every
                # figure in this table is 1-in-SAMPLE sampled, scaled back
                # to op/byte/second units).
                "seconds": round(self._handle[op].sum * self.SAMPLE, 9),
                "handle": self._handle[op].doc(),
                "wait": self._wait[op].doc(),
            }
        return {
            "schema": SCHEMA,
            "enabled": True,
            "sample": self.SAMPLE,
            "uptime_s": round(time.time() - self.started_at, 3),
            "bytes": {"in": self.bytes_in, "out": self.bytes_out},
            "conns_total": self.conns_total,
            "conns_peak": self.conns_peak,
            "dedup": {
                "hits": self.dedup_hits,
                "lookups": self.dedup_lookups,
                "hit_rate": (
                    round(self.dedup_hits / self.dedup_lookups, 6)
                    if self.dedup_lookups else 0.0
                ),
            },
            "ops": ops,
            "hot_prefixes": self.hot.items(top=16),
        }

    def take_deltas(self) -> Optional[dict]:
        """Counter movement since the previous call, for the periodic
        ``store_stats`` event — replaying the deltas reconstructs the same
        monotonic totals the live view holds (the ``goodput_update``
        discipline). Returns ``None`` when nothing moved."""
        pub = self._published
        ops: dict[str, int] = {}
        op_seconds: dict[str, float] = {}
        for op, row in self.rows.items():
            d = row[0] - pub["ops"].get(op, 0)
            if d > 0:
                ops[op] = d
                pub["ops"][op] = row[0]
            # sampled-scaled estimate (the only clocked figure in the event)
            est = self._handle[op].sum * self.SAMPLE
            ds = est - pub["op_seconds"].get(op, 0.0)
            if ds > 1e-9:
                op_seconds[op] = round(ds, 9)
                pub["op_seconds"][op] = est
        d_in = self.bytes_in - pub["bytes_in"]
        d_out = self.bytes_out - pub["bytes_out"]
        pub["bytes_in"] = self.bytes_in
        pub["bytes_out"] = self.bytes_out
        if not ops and d_in <= 0 and d_out <= 0:
            return None
        out: dict[str, Any] = {"ops": ops, "op_seconds": op_seconds}
        if d_in > 0:
            out["bytes_in"] = d_in
        if d_out > 0:
            out["bytes_out"] = d_out
        return out


def merge_stats_docs(
    docs: list[dict],
    successor_map: Optional[dict[int, int]] = None,
    failover_ops: Optional[dict[int, int]] = None,
) -> dict:
    """Fold per-shard ``tpu-store-stats-1`` documents into one clique view
    (``ShardedKVClient.store_stats`` and ``tpu-store-info --stats`` over a
    sharded endpoint list).

    Merge algebra mirrors the mergeable metrics registry: counters sum
    (op counts, errors, bytes, seconds, conns, dedup, keys, parked), gauges
    take the documented extreme (``uptime_s`` max). Quantiles cannot be
    re-derived from per-shard summaries, so the aggregate reports the
    **worst shard** per op (``p50/p95/p99/max`` maxima) — conservative for
    alerting, and each shard's exact document survives in the per-shard
    ``shards`` table the callers fold in alongside. ``backend`` merges to the
    single common value or a comma-joined set when shards disagree
    (mid-rolling-upgrade cliques render honestly instead of guessing).

    HA accounting: ``successor_map`` (shard → successor index, from a
    replicating clique client) annotates each unreachable shard's row with
    ``absorbed_by`` (the successor now serving its keyspace) and the
    successor's row with ``absorbing`` — and ``failover_ops`` (shard →
    client-observed failover count against that shard) lands as
    ``failover_ops`` **on the successor's row**, so ops that the dead shard
    can no longer report are counted where they were actually served instead
    of silently dropped: the clique-total the ``<5%`` opstats overhead gate
    reads stays a true total during degraded operation. The successor's own
    served-op counters already include the absorbed traffic (it served it);
    ``failover_ops`` is the *attribution* column, never double-summed into
    ``ops_total``.
    """
    enabled = [d for d in docs if d.get("enabled")]
    backends = sorted({
        str(d.get("backend", "threaded")) for d in docs if d.get("enabled")
    })
    out: dict[str, Any] = {
        "schema": SCHEMA,
        "enabled": bool(enabled),
        "aggregate_of": len(docs),
        "backend": ",".join(backends) if backends else "unknown",
        "uptime_s": max((d.get("uptime_s", 0.0) for d in enabled), default=0.0),
        "sample": max((d.get("sample", 0) for d in enabled), default=0),
    }
    for counter in ("conns", "parked", "barriers_open", "keys",
                    "dedup_entries", "conns_total", "conns_peak"):
        out[counter] = sum(int(d.get(counter, 0) or 0) for d in docs)
    out["bytes"] = {
        "in": sum((d.get("bytes") or {}).get("in", 0) for d in enabled),
        "out": sum((d.get("bytes") or {}).get("out", 0) for d in enabled),
    }
    hits = sum((d.get("dedup") or {}).get("hits", 0) for d in enabled)
    lookups = sum((d.get("dedup") or {}).get("lookups", 0) for d in enabled)
    out["dedup"] = {
        "hits": hits, "lookups": lookups,
        "hit_rate": round(hits / lookups, 6) if lookups else 0.0,
    }
    ops: dict[str, dict] = {}
    for d in enabled:
        for op, row in (d.get("ops") or {}).items():
            agg = ops.setdefault(op, {
                "count": 0, "errors": 0, "bytes_in": 0, "seconds": 0.0,
                "handle": {"count": 0, "p50_us": 0.0, "p95_us": 0.0,
                           "p99_us": 0.0, "max_us": 0.0},
                "wait": {"count": 0, "p50_us": 0.0, "p95_us": 0.0,
                         "p99_us": 0.0, "max_us": 0.0},
            })
            for k in ("count", "errors", "bytes_in"):
                agg[k] += row.get(k, 0)
            agg["seconds"] = round(agg["seconds"] + row.get("seconds", 0.0), 9)
            for split in ("handle", "wait"):
                src = row.get(split) or {}
                dst = agg[split]
                dst["count"] += src.get("count", 0)
                for q in ("p50_us", "p95_us", "p99_us", "max_us"):
                    dst[q] = max(dst[q], src.get(q, 0.0))
    out["ops"] = {op: ops[op] for op in sorted(ops)}
    hot = SpaceSaving(32)
    for d in enabled:
        for row in d.get("hot_prefixes") or []:
            try:
                hot.add(str(row["prefix"]), int(row["count"]))
            except (KeyError, TypeError, ValueError):
                continue
    out["hot_prefixes"] = hot.items(top=16)
    rows = [
        {
            "endpoint": d.get("endpoint", f"#{i}"),
            "enabled": bool(d.get("enabled")),
            # A doc with neither backend nor live conn counts never came from
            # a server at all (transport failure row); a reachable pre-epoll
            # server simply lacks the field.
            "backend": "unreachable"
            if "backend" not in d and "conns" not in d
            else str(d.get("backend", "threaded")),
            "ops_total": sum(
                r.get("count", 0) for r in (d.get("ops") or {}).values()
            ),
            "errors_total": sum(
                r.get("errors", 0) for r in (d.get("ops") or {}).values()
            ),
            "bytes_in": (d.get("bytes") or {}).get("in", 0),
            "bytes_out": (d.get("bytes") or {}).get("out", 0),
            "conns": d.get("conns", 0),
            "parked": d.get("parked", 0),
            "keys": d.get("keys", 0),
            **({"error": d["error"]} if d.get("error") else {}),
        }
        for i, d in enumerate(docs)
    ]
    if successor_map:
        for i, row in enumerate(rows):
            if row["backend"] != "unreachable":
                continue
            succ = successor_map.get(i)
            if succ is None or succ == i or not (0 <= succ < len(rows)):
                continue
            row["absorbed_by"] = rows[succ]["endpoint"]
            absorbing = rows[succ].setdefault("absorbing", [])
            absorbing.append(row["endpoint"])
    if failover_ops:
        total = 0
        for i, n_ops in sorted(failover_ops.items()):
            if n_ops <= 0:
                continue
            total += int(n_ops)
            succ = (successor_map or {}).get(i)
            tgt = succ if succ is not None and 0 <= succ < len(rows) else None
            if tgt is not None and tgt != i:
                rows[tgt]["failover_ops"] = (
                    rows[tgt].get("failover_ops", 0) + int(n_ops)
                )
        if total:
            out["failover"] = {
                "ops": total,
                "by_shard": {
                    int(i): int(n) for i, n in sorted(failover_ops.items()) if n > 0
                },
            }
    out["shards"] = rows
    return out
