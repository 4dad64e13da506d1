"""Op-storm benchmarks for the coordination store: before AND after.

**Baseline leg** (default): N concurrent clients on loopback hammer one
:class:`KVServer` with the mixed small-op workload the launcher actually
generates (set/get/add/touch + a periodic prefix scan); the report is
client-observed p50/p95 latency and aggregate throughput per concurrency
level, plus the server's OWN ``store_stats`` view of the same storm (handle
vs queue-wait split). This is the committed ``BENCH_store_baseline.json``
"before" curve ROADMAP item 2 is judged against.

**Telemetry overhead leg**: the same storm against a ``stats_enabled=False``
control server. Per-op accounting must cost <5% of client-observed p50
(``tests/platform/test_store_perf.py`` enforces the gate).

**Scale leg** (``--ranks N``): the "after" picture — a simulated N-rank
rendezvous + barrier storm + metrics-push storm against a **sharded clique**
of ``--shards`` KVServer *processes*, driven by ``--procs`` light loopback
worker processes each multiplexing a contiguous slice of ranks. The tree
barrier executes level-stepped (deepest level first, an mp barrier between
levels), which is DAG-faithful: op counts, key layout, and shard routing are
exactly the deployment protocol's — only the park-and-wake idling is elided,
so the measured figures are store service times, the quantity the baseline
curve also measures. The report: per-op p50/p95 across the storm (the
apples-to-apples number vs the baseline's 64-client point), per-shard op
totals from the aggregated ``store_stats`` (how evenly the hash spreads the
storm), and a flat-vs-tree comparison table with analytic critical-path hop
counts (``treecomm.flat_hops``/``tree_hops``) plus measured per-rank op
counts and wall clocks. Committed as ``BENCH_store_scale.json``.

Usage::

    python -m tpu_resiliency_torch.scripts.bench_store [--ops N] [--out BENCH_store_baseline.json]
    python -m tpu_resiliency_torch.scripts.bench_store --ranks 4096 --shards 4   # scale storm
    python -m tpu_resiliency_torch.scripts.bench_store --smoke     # CI: tiny storm, sanity asserts
    python -m tpu_resiliency_torch.scripts.bench_store --smoke --ranks 128 --shards 2  # + scale leg
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import platform
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from tpu_resiliency_torch.scripts import DEFAULT_OUT_DIR  # noqa: E402

from tpu_resiliency_torch.platform.store import KVClient, KVServer  # noqa: E402

#: concurrency levels of the committed baseline curve
LEVELS = (1, 4, 16, 64)


def storm_client(port: int, client_id: int, ops: int, q) -> None:
    """One client's slice of the storm: the launcher-shaped small-op mix,
    per-op latency sampled client-side (the operator-visible number)."""
    c = KVClient("127.0.0.1", port, timeout=30.0)
    lat: list[float] = []
    try:
        for i in range(ops):
            kind = i % 8
            key = f"storm/c{client_id}/k{i % 16}"
            t0 = time.perf_counter()
            if kind < 3:
                c.set(key, i)
            elif kind < 6:
                c.try_get(key)
            elif kind == 6:
                c.add(f"storm/c{client_id}/ctr", 1)
            else:
                c.touch(f"storm/hb/c{client_id}")
            lat.append(time.perf_counter() - t0)
            if i % 64 == 63:
                t0 = time.perf_counter()
                c.prefix_get(f"storm/c{client_id}/")
                lat.append(time.perf_counter() - t0)
    finally:
        c.close()
    q.put((client_id, lat))


def run_storm(port: int, clients: int, ops_per_client: int) -> dict:
    """Storm with client PROCESSES — the deployment shape (workers are
    separate processes), and the measurement shape: in-process client threads
    would share the server loop's GIL and misattribute their own framing cost
    to server latency."""
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=storm_client, args=(port, i, ops_per_client, q))
        for i in range(clients)
    ]
    t_start = time.perf_counter()
    for p in procs:
        p.start()
    lats: list[float] = []
    for _ in range(clients):
        _, lat = q.get(timeout=300)
        lats.extend(lat)
    wall = time.perf_counter() - t_start
    for p in procs:
        p.join(20.0)
        if p.is_alive():
            p.terminate()
    lats.sort()

    def qtile(p: float) -> float:
        return lats[min(len(lats) - 1, int(p * len(lats)))]

    return {
        "clients": clients,
        "ops": len(lats),
        "p50_us": round(qtile(0.50) * 1e6, 2),
        "p95_us": round(qtile(0.95) * 1e6, 2),
        "p99_us": round(qtile(0.99) * 1e6, 2),
        "ops_per_s": round(len(lats) / wall, 1),
        "wall_s": round(wall, 3),
    }


def bench_levels(levels=LEVELS, ops_per_client: int = 1500) -> dict:
    """The latency-vs-concurrency curve, one server for the whole sweep (the
    production shape: one store outlives every client), plus the server's own
    store_stats account of it."""
    srv = KVServer(host="127.0.0.1", port=0, stats_interval=3600.0)
    try:
        rows = [run_storm(srv.port, n, ops_per_client) for n in levels]
        probe = KVClient("127.0.0.1", srv.port)
        try:
            stats = probe.store_stats()
        finally:
            probe.close()
        # Trim the per-op table to the storm's hot ops (the committed JSON
        # stays reviewable).
        stats["ops"] = {
            op: row for op, row in (stats.get("ops") or {}).items()
            if row.get("count", 0) >= len(levels)
        }
        return {"levels": rows, "store_stats": stats}
    finally:
        srv.close()


def bench_overhead(clients: int = 1, ops_per_client: int = 1500,
                   trials: int = 9) -> dict:
    """Client-observed p50 with per-op telemetry on vs off: N interleaved
    trials per mode (on/off alternating, fresh server each — background-load
    spikes hit both arms), compared by MEDIAN. One client on purpose — no
    queueing amplification, so the delta is the collector's own service-time
    tax, the number the <5% gate is about."""
    import statistics

    p50 = {True: [], False: []}
    for _ in range(trials):
        for enabled in (True, False):
            srv = KVServer(
                host="127.0.0.1", port=0,
                stats_enabled=enabled, stats_interval=3600.0,
            )
            try:
                p50[enabled].append(
                    run_storm(srv.port, clients, ops_per_client)["p50_us"]
                )
            finally:
                srv.close()
    on = statistics.median(p50[True])
    off = statistics.median(p50[False])
    return {
        "clients": clients,
        "trials": trials,
        "stats_on_p50_us": round(on, 2),
        "stats_off_p50_us": round(off, 2),
        "overhead_frac": round(on / off - 1.0, 4) if off else None,
        "p50_us_all": {"on": p50[True], "off": p50[False]},
    }


# -- scale leg: sharded clique + tree collectives ---------------------------


def _quantiles(lats: list) -> dict:
    lats = sorted(lats)

    def q(p: float) -> float:
        return lats[min(len(lats) - 1, int(p * len(lats)))] if lats else 0.0

    return {
        "ops": len(lats),
        "p50_us": round(q(0.50) * 1e6, 2),
        "p95_us": round(q(0.95) * 1e6, 2),
        "p99_us": round(q(0.99) * 1e6, 2),
    }


def _storm_worker(spec: str, proc_id: int, ranks: range, world: int,
                  fanout: int, rounds: int, depth: int, lvl_barrier, q) -> None:
    """One light loopback process multiplexing ``ranks``: per round, the
    rendezvous write burst, the level-stepped tree barrier (exact deployment
    key layout/op counts — see module doc), and the metrics-push burst.
    Reports (proc_id, per-op latencies, per-rank op count)."""
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, parse_endpoints
    from tpu_resiliency_torch.platform.treecomm import children, tree_depth

    c = ShardedKVClient(parse_endpoints(spec), timeout=60.0)
    lat: list[float] = []
    ops_by_rank = dict.fromkeys(ranks, 0)

    def op(rank, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        lat.append(time.perf_counter() - t0)
        ops_by_rank[rank] += 1
        return out

    def depth_of(i: int) -> int:
        d = 0
        while i > 0:
            i = (i - 1) // fanout
            d += 1
        return d

    try:
        for r in range(1, rounds + 1):
            # Phase 1: rendezvous registration burst (keyed writes, scattered
            # across shards by hash — the round-open census shape).
            for rank in ranks:
                op(rank, c.set, f"rdzv/r{r}/{rank}", rank)
            lvl_barrier.wait()
            # Phase 2: tree barrier, level-stepped. Up: deepest level first,
            # so every child's arrival key is committed before its parent
            # reads it (the parked wait of the live protocol, minus idling).
            for lvl in range(depth, -1, -1):
                for rank in ranks:
                    if depth_of(rank) != lvl:
                        continue
                    for ch in children(rank, world, fanout):
                        got = op(rank, c.get, f"bar/u/{ch}", 30.0)
                        assert got == r, (ch, got, r)
                    if rank != 0:
                        op(rank, c.set, f"bar/u/{rank}", r)
                lvl_barrier.wait()
            # Down: release propagates root→leaves on per-child keys.
            for lvl in range(0, depth + 1):
                for rank in ranks:
                    if depth_of(rank) != lvl:
                        continue
                    if rank != 0:
                        got = op(rank, c.get, f"bar/d/{rank}", 30.0)
                        assert got == r, (rank, got, r)
                    for ch in children(rank, world, fanout):
                        op(rank, c.set, f"bar/d/{ch}", r)
                lvl_barrier.wait()
            # Phase 3: metrics-push burst (heartbeat touch + snapshot set —
            # the per-tick publisher shape).
            for rank in ranks:
                op(rank, c.touch, f"mhb/{rank}")
                op(rank, c.set, f"jobmetrics/{rank}", {"rank": rank, "round": r})
            lvl_barrier.wait()
    finally:
        c.close()
    q.put((proc_id, lat, max(ops_by_rank.values()) if ops_by_rank else 0))


def bench_scale(ranks: int = 4096, shards: int = 4, procs: int = 16,
                rounds: int = 3, fanout: int = 8) -> dict:
    """The simulated N-rank storm against a spawned shard clique."""
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, SpawnedClique
    from tpu_resiliency_torch.platform.treecomm import flat_hops, tree_depth, tree_hops

    procs = min(procs, ranks)
    clique = SpawnedClique(shards)
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    depth = tree_depth(ranks, fanout)
    lvl_barrier = ctx.Barrier(procs)
    slices = []
    per = ranks // procs
    extra = ranks % procs
    lo = 0
    for i in range(procs):
        hi = lo + per + (1 if i < extra else 0)
        slices.append(range(lo, hi))
        lo = hi
    try:
        workers = [
            ctx.Process(
                target=_storm_worker,
                args=(clique.spec, i, slices[i], ranks, fanout, rounds,
                      depth, lvl_barrier, q),
            )
            for i in range(procs)
        ]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        lats: list[float] = []
        max_rank_ops = 0
        for _ in range(procs):
            _, lat, rank_ops = q.get(timeout=600)
            lats.extend(lat)
            max_rank_ops = max(max_rank_ops, rank_ops)
        wall = time.perf_counter() - t0
        for w in workers:
            w.join(30.0)
            if w.is_alive():
                w.terminate()
        probe = ShardedKVClient(clique.endpoints)
        try:
            stats = probe.store_stats()
        finally:
            probe.close()
    finally:
        clique.close()
    shard_ops = [s["ops_total"] for s in stats.get("shards", [])]
    total_shard_ops = sum(shard_ops) or 1
    return {
        "ranks": ranks,
        "shards": shards,
        "procs": procs,
        "rounds": rounds,
        "fanout": fanout,
        **_quantiles(lats),
        "ops_per_s": round(len(lats) / wall, 1) if wall else 0.0,
        "wall_s": round(wall, 3),
        "max_ops_per_rank_per_round": round(max_rank_ops / rounds, 1),
        "hops": {
            "flat": flat_hops(ranks),
            "tree": tree_hops(ranks, fanout),
            "win": round(flat_hops(ranks) / tree_hops(ranks, fanout), 1),
        },
        "shard_balance": {
            "backend": stats.get("backend"),
            "per_shard_ops": shard_ops,
            # 1/shards is perfect balance; 1.0 means one loop served it all.
            "busiest_shard_frac": round(max(shard_ops) / total_shard_ops, 3)
            if shard_ops else 1.0,
        },
    }


def bench_tree_vs_flat(sizes=(64, 256, 1024), fanout: int = 8,
                       shards: int = 4, procs: int = 8) -> list[dict]:
    """Flat vs tree collective round at each world size, same clique: wall
    clock, per-rank op ceiling, and the analytic critical-path hop counts
    the ≥4×-at-256 acceptance gate reads. The flat leg reproduces today's
    ``StoreComm.all_gather`` op sequence (set + entry barrier + prefix_get +
    exit barrier); the tree leg is the level-stepped tree gather."""
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, SpawnedClique
    from tpu_resiliency_torch.platform.treecomm import flat_hops, tree_depth, tree_hops

    out = []
    clique = SpawnedClique(shards)
    ctx = mp.get_context("fork")
    try:
        for world in sizes:
            nproc = min(procs, world)
            q = ctx.Queue()
            lvl_barrier = ctx.Barrier(nproc)
            per = world // nproc
            extra = world % nproc
            slices, lo = [], 0
            for i in range(nproc):
                hi = lo + per + (1 if i < extra else 0)
                slices.append(range(lo, hi))
                lo = hi

            def run(target):
                workers = [
                    ctx.Process(
                        target=target,
                        args=(clique.spec, i, slices[i], world, fanout,
                              lvl_barrier, q),
                    )
                    for i in range(nproc)
                ]
                t0 = time.perf_counter()
                for w in workers:
                    w.start()
                lats, rank_ops = [], 0
                for _ in range(nproc):
                    _, lat, ro = q.get(timeout=600)
                    lats.extend(lat)
                    rank_ops = max(rank_ops, ro)
                wall = time.perf_counter() - t0
                for w in workers:
                    w.join(30.0)
                return wall, lats, rank_ops

            flat_wall, flat_lats, flat_rank_ops = run(_flat_gather_worker)
            tree_wall, tree_lats, tree_rank_ops = run(_tree_gather_worker)
            out.append({
                "world": world,
                "flat": {"wall_s": round(flat_wall, 3),
                         "ops_per_rank": flat_rank_ops,
                         "hops": flat_hops(world), **_quantiles(flat_lats)},
                "tree": {"wall_s": round(tree_wall, 3),
                         "ops_per_rank": tree_rank_ops,
                         "hops": tree_hops(world, fanout),
                         "depth": tree_depth(world, fanout),
                         **_quantiles(tree_lats)},
                "hop_win": round(flat_hops(world) / tree_hops(world, fanout), 1),
            })
    finally:
        clique.close()
    return out


def _flat_gather_worker(spec, proc_id, ranks, world, fanout, lvl_barrier, q):
    """Today's flat all_gather shape: value set, entry barrier (non-blocking
    registration — the level-stepped stand-in for the parked join), one
    whole-world prefix_get per rank, exit barrier."""
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, parse_endpoints

    c = ShardedKVClient(parse_endpoints(spec), timeout=60.0)
    lat, ops = [], dict.fromkeys(ranks, 0)

    def op(rank, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        lat.append(time.perf_counter() - t0)
        ops[rank] += 1
        return out

    try:
        for rank in ranks:
            op(rank, c.set, f"fg{world}/v/{rank}", rank)
            op(rank, c.barrier_join, f"fg{world}/b0", rank, world, 30.0, False)
        lvl_barrier.wait()
        for rank in ranks:
            vals = op(rank, c.prefix_get, f"fg{world}/v/")
            assert len(vals) == world, (rank, len(vals))
            op(rank, c.barrier_join, f"fg{world}/b1", rank, world, 30.0, False)
        lvl_barrier.wait()
    finally:
        c.close()
    q.put((proc_id, lat, max(ops.values()) if ops else 0))


def _tree_gather_worker(spec, proc_id, ranks, world, fanout, lvl_barrier, q):
    """The tree all_gather DAG, level-stepped: fan-in merged dicts up,
    result fan-out down per-child keys, ack fan-in, root GC."""
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, parse_endpoints
    from tpu_resiliency_torch.platform.treecomm import children, tree_depth

    c = ShardedKVClient(parse_endpoints(spec), timeout=60.0)
    lat, ops = [], dict.fromkeys(ranks, 0)
    depth = tree_depth(world, fanout)

    def op(rank, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        lat.append(time.perf_counter() - t0)
        ops[rank] += 1
        return out

    def depth_of(i):
        d = 0
        while i > 0:
            i = (i - 1) // fanout
            d += 1
        return d

    try:
        for lvl in range(depth, -1, -1):  # fan-in
            for rank in ranks:
                if depth_of(rank) != lvl:
                    continue
                merged = {rank: rank}
                for ch in children(rank, world, fanout):
                    merged.update(op(rank, c.get, f"tg{world}/v/{ch}", 30.0))
                if rank == 0:
                    assert len(merged) == world, len(merged)
                    for ch in children(rank, world, fanout):
                        op(rank, c.set, f"tg{world}/res/{ch}", merged)
                else:
                    op(rank, c.set, f"tg{world}/v/{rank}", merged)
            lvl_barrier.wait()
        for lvl in range(1, depth + 1):  # result fan-out
            for rank in ranks:
                if depth_of(rank) != lvl:
                    continue
                res = op(rank, c.get, f"tg{world}/res/{rank}", 30.0)
                assert len(res) == world, (rank, len(res))
                for ch in children(rank, world, fanout):
                    op(rank, c.set, f"tg{world}/res/{ch}", res)
            lvl_barrier.wait()
        for lvl in range(depth, 0, -1):  # ack fan-in
            for rank in ranks:
                if depth_of(rank) != lvl:
                    continue
                for ch in children(rank, world, fanout):
                    op(rank, c.get, f"tg{world}/a/{ch}", 30.0)
                op(rank, c.set, f"tg{world}/a/{rank}", 1)
            lvl_barrier.wait()
        for rank in ranks:
            if rank == 0:
                for ch in children(0, world, fanout):
                    op(rank, c.get, f"tg{world}/a/{ch}", 30.0)
                op(rank, c.prefix_clear, f"tg{world}/")
        lvl_barrier.wait()
    finally:
        c.close()
    q.put((proc_id, lat, max(ops.values()) if ops else 0))


def _failover_storm_worker(spec, client_id, ops, q):
    """One replicated client's slice of the failover storm: the same
    launcher-shaped mix as :func:`storm_client`, but through a replicating
    ``ShardedKVClient`` (every write double-writes to the successor). The
    untimed warmup trips this process's circuit breaker for any dead shard,
    so the timed ops measure STEADY-STATE failover routing — the transient
    trip cost is the chaos scenario's business, not this gate's."""
    from tpu_resiliency_torch.exceptions import StoreError
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, parse_endpoints

    c = ShardedKVClient(
        parse_endpoints(spec), timeout=30.0, connect_retries=2,
        retry_budget=0.5, replicate=True,
    )
    lat: list[float] = []
    try:
        for i in range(24):
            try:
                c.set(f"fstorm/c{client_id}/warm{i % 4}", i)
                c.try_get(f"fstorm/c{client_id}/warm{i % 4}")
            except StoreError:
                pass
        for i in range(ops):
            kind = i % 8
            key = f"fstorm/c{client_id}/k{i % 16}"
            t0 = time.perf_counter()
            if kind < 3:
                c.set(key, i)
            elif kind < 6:
                c.try_get(key)
            elif kind == 6:
                c.add(f"fstorm/c{client_id}/ctr", 1)
            else:
                c.touch(f"fstorm/hb/c{client_id}")
            lat.append(time.perf_counter() - t0)
    finally:
        c.close()
    q.put((client_id, lat))


def bench_failover_storm(clients: int = 8, ops_per_client: int = 800,
                         shards: int = 3) -> dict:
    """Storm-under-failover: the same replicated storm healthy, then again
    with one shard SIGKILLed (clients route its keyspace to the successor
    replica). The committed ``p95_ratio`` is THE degraded-operation
    acceptance number: failover must cost ≤2× the healthy p95
    (``tests/platform/test_store_perf.py`` pins it)."""
    from tpu_resiliency_torch.platform.shardstore import SpawnedClique

    clique = SpawnedClique(shards)
    ctx = mp.get_context("fork")

    def leg() -> dict:
        q = ctx.Queue()
        procs = [
            ctx.Process(target=_failover_storm_worker,
                        args=(clique.spec, i, ops_per_client, q))
            for i in range(clients)
        ]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        lats: list[float] = []
        for _ in range(clients):
            _, lat = q.get(timeout=300)
            lats.extend(lat)
        wall = time.perf_counter() - t0
        for p in procs:
            p.join(20.0)
            if p.is_alive():
                p.terminate()
        return {
            "ops": len(lats), "wall_s": round(wall, 3),
            "ops_per_s": round(len(lats) / wall, 1), **_quantiles(lats),
        }

    victim = shards // 2
    try:
        healthy = leg()
        clique.procs[victim].kill()
        time.sleep(0.2)
        degraded = leg()
    finally:
        clique.close()
    return {
        "clients": clients, "shards": shards, "victim_shard": victim,
        "healthy": healthy, "degraded": degraded,
        "p95_ratio": round(degraded["p95_us"] / healthy["p95_us"], 3)
        if healthy["p95_us"] else None,
    }


def _flat_join_worker(spec, proc_id, ranks, q):
    """The flat rendezvous join ladder: every rank CAS-appends itself to the
    ONE state key — N contended read-modify-writes against a single shard,
    each carrying the whole O(N) participant list back and forth."""
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, parse_endpoints

    c = ShardedKVClient(parse_endpoints(spec), timeout=60.0)
    lat: list[float] = []

    def op(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        lat.append(time.perf_counter() - t0)
        return out

    try:
        for rank in ranks:
            while True:
                cur = op(c.try_get, "rl/flat/state")
                nxt = (cur or []) + [rank]
                ok, _ = op(c.compare_set, "rl/flat/state", cur, nxt)
                if ok:
                    break
                time.sleep(0.001)  # the real ladder's contention backoff
    finally:
        c.close()
    q.put((proc_id, lat))


def _scatter_join_worker(spec, proc_id, ranks, world, lvl_barrier, q):
    """The tree-laddered join: every rank ONE hash-scattered edge write
    (``treecomm.scatter_register``), then the leader folds the whole
    registration set with a shard-parallel prefix scan and ONE state write —
    O(N) ops spread over every shard with O(1) payloads, vs the flat arm's
    O(N) contended round trips on one shard with O(N) payloads."""
    from tpu_resiliency_torch.platform import treecomm
    from tpu_resiliency_torch.platform.shardstore import ShardedKVClient, parse_endpoints

    c = ShardedKVClient(parse_endpoints(spec), timeout=60.0)
    lat: list[float] = []

    def op(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        lat.append(time.perf_counter() - t0)
        return out

    try:
        for rank in ranks:
            op(treecomm.scatter_register, c, "rl/join", f"n{rank}")
        lvl_barrier.wait()
        if proc_id == 0:
            regs = op(treecomm.scatter_collect, c, "rl/join")
            assert len(regs) == world, (len(regs), world)
            op(c.set, "rl/scatter/state",
               {"round": 0, "parts": len(regs)})
            op(treecomm.scatter_clear, c, "rl/join")
        lvl_barrier.wait()
    finally:
        c.close()
    q.put((proc_id, lat))


def bench_rendezvous_ladder(world: int = 4096, shards: int = 4,
                            procs: int = 16) -> dict:
    """Full rendezvous join round, flat vs tree-laddered, same clique.
    The committed ``wall_win`` (flat wall / scattered wall) is the
    acceptance number: the scattered ladder must beat the flat baseline at
    4096 ranks (``tests/platform/test_store_perf.py`` pins it)."""
    from tpu_resiliency_torch.platform.shardstore import SpawnedClique

    clique = SpawnedClique(shards)
    ctx = mp.get_context("fork")
    nproc = min(procs, world)
    per, extra = world // nproc, world % nproc
    slices, lo = [], 0
    for i in range(nproc):
        hi = lo + per + (1 if i < extra else 0)
        slices.append(range(lo, hi))
        lo = hi

    def run(target, with_barrier: bool) -> tuple[float, list]:
        q = ctx.Queue()
        lvl_barrier = ctx.Barrier(nproc)
        workers = [
            ctx.Process(
                target=target,
                args=(clique.spec, i, slices[i], world, lvl_barrier, q)
                if with_barrier else (clique.spec, i, slices[i], q),
            )
            for i in range(nproc)
        ]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        lats: list[float] = []
        for _ in range(nproc):
            _, lat = q.get(timeout=600)
            lats.extend(lat)
        wall = time.perf_counter() - t0
        for w in workers:
            w.join(30.0)
        return wall, lats

    try:
        flat_wall, flat_lats = run(_flat_join_worker, with_barrier=False)
        scatter_wall, scatter_lats = run(_scatter_join_worker, with_barrier=True)
    finally:
        clique.close()
    return {
        "world": world, "shards": shards, "procs": nproc,
        "flat": {"wall_s": round(flat_wall, 3), "ops": len(flat_lats),
                 **_quantiles(flat_lats)},
        "scattered": {"wall_s": round(scatter_wall, 3),
                      "ops": len(scatter_lats), **_quantiles(scatter_lats)},
        "wall_win": round(flat_wall / scatter_wall, 2) if scatter_wall else None,
    }


def bench_scale_report(ranks: int, shards: int, procs: int, rounds: int,
                       fanout: int, compare_sizes) -> dict:
    """The full scale leg + the committed baseline replayed side-by-side."""
    storm = bench_scale(ranks=ranks, shards=shards, procs=procs,
                        rounds=rounds, fanout=fanout)
    compare = bench_tree_vs_flat(
        sizes=tuple(s for s in compare_sizes if s <= ranks) or (ranks,),
        fanout=fanout, shards=shards,
        procs=min(procs, 8),
    )
    report = {
        "host": platform.node(),
        "cpus": os.cpu_count(),
        "storm": storm,
        "tree_vs_flat": compare,
        # Degraded-operation leg: the replicated storm with one shard
        # SIGKILLed vs healthy. p95_ratio ≤ 2.0 is the committed gate.
        "failover": bench_failover_storm(shards=shards),
        # Tree-laddered rendezvous join round vs the flat CAS ladder at the
        # storm's rank count. wall_win > 1.0 is the committed gate.
        "rendezvous_ladder": bench_rendezvous_ladder(
            world=ranks, shards=shards, procs=procs,
        ),
    }
    base_path = os.path.join(DEFAULT_OUT_DIR, "BENCH_store_baseline.json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        levels = base.get("levels") or []
        report["baseline"] = {
            "p50_us_by_clients": {str(r["clients"]): r["p50_us"] for r in levels},
            "p95_us_by_clients": {str(r["clients"]): r["p95_us"] for r in levels},
        }
        b64 = next((r for r in levels if r.get("clients") == 64), None)
        if b64:
            # THE acceptance ratio: per-op p95 under the N-rank sharded storm
            # vs the flat server's 64-client point. <2.0 = the curve held.
            report["p95_vs_baseline64"] = round(
                storm["p95_us"] / b64["p95_us"], 3
            ) if b64["p95_us"] else None
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ops", type=int, default=1500,
                    help="ops per client per level")
    ap.add_argument(
        "--out", default=os.path.join(DEFAULT_OUT_DIR, "BENCH_store_baseline.json")
    )
    ap.add_argument(
        "--smoke", action="store_true",
        help="tiny storm asserting the telemetry answers (op counts, wait/"
        "handle split, hot prefixes) without writing the committed file; "
        "with --ranks, also a reduced sharded scale storm with its own "
        "sanity asserts",
    )
    ap.add_argument(
        "--ranks", type=int, default=0,
        help="run the SCALE leg: simulated N-rank rendezvous + tree-barrier "
        "+ metrics-push storm over a sharded clique; writes "
        "BENCH_store_scale.json (unless --smoke)",
    )
    ap.add_argument("--shards", type=int, default=4,
                    help="store clique size for the scale leg")
    ap.add_argument("--procs", type=int, default=16,
                    help="worker processes multiplexing the simulated ranks")
    ap.add_argument("--rounds", type=int, default=3,
                    help="storm rounds (rendezvous+barrier+metrics each)")
    ap.add_argument("--fanout", type=int, default=8, help="tree arity")
    ap.add_argument(
        "--scale-out",
        default=os.path.join(DEFAULT_OUT_DIR, "BENCH_store_scale.json"),
        help="output for the scale leg's committed report",
    )
    args = ap.parse_args(argv)
    os.makedirs(DEFAULT_OUT_DIR, exist_ok=True)

    if args.smoke:
        res = bench_levels(levels=(2,), ops_per_client=200)
        print(json.dumps({"layer": "store-storm", **res["levels"][0]}))
        stats = res["store_stats"]
        ok = (
            stats.get("enabled") is True
            and stats.get("backend") == "epoll"
            and stats.get("ops", {}).get("set", {}).get("count", 0) > 0
            and stats["ops"]["set"]["handle"]["p50_us"] > 0
            and stats["ops"]["set"]["wait"]["count"] > 0
            and any(
                r["prefix"].startswith("storm/")
                for r in stats.get("hot_prefixes", [])
            )
            and stats.get("bytes", {}).get("in", 0) > 0
        )
        print(json.dumps({"bench_store_smoke": "PASS" if ok else "FAIL",
                          "stats_enabled": stats.get("enabled"),
                          "backend": stats.get("backend")}))
        if ok and args.ranks:
            # Reduced sharded storm: the scale plumbing end to end (clique
            # spawn, hash fan-out, tree DAG, aggregated per-shard stats).
            storm = bench_scale(
                ranks=args.ranks, shards=args.shards,
                procs=min(args.procs, 4), rounds=1, fanout=args.fanout,
            )
            bal = storm["shard_balance"]
            scale_ok = (
                storm["p95_us"] > 0
                and storm["hops"]["tree"] < storm["hops"]["flat"]
                and bal["backend"] == "epoll"
                and len(bal["per_shard_ops"]) == args.shards
                and sum(bal["per_shard_ops"]) > 0
                and bal["busiest_shard_frac"] < 1.0
            )
            print(json.dumps({
                "layer": "store-scale-storm", "ranks": storm["ranks"],
                "shards": storm["shards"], "p95_us": storm["p95_us"],
                "hop_win": storm["hops"]["win"],
                "busiest_shard_frac": bal["busiest_shard_frac"],
            }))
            print(json.dumps(
                {"bench_store_scale_smoke": "PASS" if scale_ok else "FAIL"}
            ))
            ok = ok and scale_ok
            # Reduced failover + rendezvous-ladder legs: the HA plumbing end
            # to end (replicated double-writes, SIGKILL, breaker-routed
            # successor reads, scattered join fold) with sanity asserts.
            fo = bench_failover_storm(
                clients=2, ops_per_client=120, shards=min(args.shards, 3) or 2,
            )
            rl = bench_rendezvous_ladder(
                world=min(args.ranks, 128), shards=args.shards, procs=4,
            )
            ha_ok = (
                fo["healthy"]["p95_us"] > 0
                and fo["degraded"]["p95_us"] > 0
                and fo["degraded"]["ops"] == fo["healthy"]["ops"]
                and rl["flat"]["wall_s"] > 0
                and rl["scattered"]["wall_s"] > 0
            )
            print(json.dumps({
                "layer": "store-failover-storm",
                "p95_ratio": fo["p95_ratio"],
                "ladder_wall_win": rl["wall_win"],
            }))
            print(json.dumps(
                {"bench_store_failover_smoke": "PASS" if ha_ok else "FAIL"}
            ))
            ok = ok and ha_ok
        return 0 if ok else 1

    if args.ranks:
        report = bench_scale_report(
            ranks=args.ranks, shards=args.shards, procs=args.procs,
            rounds=args.rounds, fanout=args.fanout,
            compare_sizes=(64, 256, 1024),
        )
        with open(args.scale_out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(json.dumps({
            "metric": "sharded-store scale storm (simulated ranks, loopback)",
            "ranks": report["storm"]["ranks"],
            "shards": report["storm"]["shards"],
            "p50_us": report["storm"]["p50_us"],
            "p95_us": report["storm"]["p95_us"],
            "p95_vs_baseline64": report.get("p95_vs_baseline64"),
            "busiest_shard_frac":
                report["storm"]["shard_balance"]["busiest_shard_frac"],
            "hop_win_at": {
                str(row["world"]): row["hop_win"]
                for row in report["tree_vs_flat"]
            },
        }))
        return 0

    curve = bench_levels(levels=LEVELS, ops_per_client=args.ops)
    for row in curve["levels"]:
        print(json.dumps({"layer": "store-storm", **row}))
    overhead = bench_overhead()
    print(json.dumps({"layer": "telemetry-overhead", **overhead}))
    summary = {
        "host": platform.node(),
        "cpus": os.cpu_count(),
        **curve,
        "telemetry_overhead": overhead,
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
        f.write("\n")
    print(json.dumps({
        "metric": "flat-store op latency vs concurrency (loopback, "
                  "client-observed)",
        "p50_us_by_clients": {
            str(r["clients"]): r["p50_us"] for r in curve["levels"]
        },
        "p95_us_by_clients": {
            str(r["clients"]): r["p95_us"] for r in curve["levels"]
        },
        "telemetry_overhead_frac": overhead["overhead_frac"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
