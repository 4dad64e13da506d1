"""Benchmark the pipelined snapshot engine on the card: foreground stall vs the sync path.

Port of ``scripts/bench_ckpt_save.py``: the same legs, options and keys, on the port's
checkpoint package with the tree's leaves on the card. Drives the exact save paths a
training loop uses, on a loopback clique of ``--world`` ranks (threads against one
``KVServer``, all on the one card), at each ``--mb`` tree size:

- **sync**: ``LocalCheckpointManager.save(pipelined=False)``: a blocking copy of the
  tree to the host, whole-tree serialize, the full replication fan-out, all inside the
  caller-visible window; only file writes are async.
- **pipelined**: the snapshot engine: the caller-visible window is enqueue + skeleton
  pickle; the device-to-host copies, peer sends and the shard write stream leaf by
  leaf in the background out of the pooled (pinned) staging buffers.

Reported per size: **foreground-blocked ms** (the time ``save()`` holds the caller,
on the host's clock, as the reference's) and **end-to-end ms** (save + blocking
finalize with coverage agreement), max across ranks per round, median across rounds;
the staging pool's stats; the delta leg (``delta_interval``: chunk-diff frames
against the full container, from the ``ckpt_delta`` / ``ckpt_delta_applied`` events)
and the cold leg (a durable cold tier attached: ``coldtier_spilled`` /
``coldtier_degraded`` events, the foreground with and without it). A single-rank
``AsyncCheckpointer`` comparison and a steady-state tracemalloc probe (peak transient
host allocation during a warm pipelined save) complete the picture.

    python -m tpu_resiliency_torch.scripts.bench_ckpt_save [--mb 256 1024] [--world 3] \\
        [--rounds 3] [--out FILE] [--device cpu]
    python -m tpu_resiliency_torch.scripts.bench_ckpt_save --smoke   # tiny run + asserts

The trees hold the reference's values (``full(seed + i)``, the first 64 elements of
the first leaf set to the round in the mutating legs), so the containers of both
packages are byte-identical. The results carry ``backend``, ``device_kind`` and
``card``.

One departure: ``--smoke`` holds the cold tier's foreground gate
(:func:`cold_foreground_unmoved`) as the best of two attempts of the cold leg, the
noise policy of the reference's other timing gates (``tests/test_bench_restart.py``),
where the reference's smoke takes one.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import platform
import shutil
import statistics
import sys
import tempfile
import time
import tracemalloc

import torch

from tpu_resiliency_torch.checkpoint.async_ckpt import AsyncCheckpointer
from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.replication import CliqueReplicationStrategy
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
from tpu_resiliency_torch.platform.device import resolve_device
from tpu_resiliency_torch.platform.store import CoordStore, KVServer
from tpu_resiliency_torch.scripts import device_fields

LEAF_MB = 16


def make_tree(mb: int, seed: float, device=None):
    """A checkpoint-shaped tree: 16 MB float32 leaves on ``device`` plus scalar state."""
    dev = resolve_device(device)
    n = max(1, mb // LEAF_MB)
    leaf = (mb * (1 << 20)) // (4 * n)
    tree = {
        "params": {f"w{i}": torch.full((leaf,), seed + i, dtype=torch.float32, device=dev)
                   for i in range(n)},
        "step": int(seed),
    }
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return tree


def _touch_tree(tree, it):
    """A steady-state step's worth of mutation: one small slice of the first
    parameter leaf moves, everything else is byte-identical — the shape the
    delta chunk-diff exploits."""
    params = dict(tree["params"])
    first = sorted(params)[0]
    leaf = params[first]
    params[first] = torch.cat(
        [torch.full((64,), float(it), dtype=leaf.dtype, device=leaf.device), leaf[64:]]
    )
    return {"params": params, "step": it}


def bench_clique(
    world: int, mb: int, rounds: int, pipelined: bool, root: str,
    delta_interval: int = 0, mutate: bool = False, cold_dir: str = None, device=None,
):
    """Per-round (foreground_s, e2e_s) as max across ranks; returns medians.

    ``delta_interval`` > 1 turns on chunk-diff replication between keyframes
    (the steady-state byte-economy leg); ``mutate`` applies a small per-round
    parameter update so consecutive saves differ realistically.
    ``cold_dir`` attaches a durable cold tier (``checkpoint/coldtier.py``)
    to every rank — the spiller's claim is that the foreground numbers do
    not move, since uploads ride the background worker off save-finalize."""
    dev = resolve_device(device)
    srv = KVServer(host="127.0.0.1", port=0)
    stores = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=300.0)
        stores.append(s)
        return s

    staging_stats = {}

    def body(rank):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=300.0)
        ex = PeerExchange(mk(), rank, timeout=300.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world
            )
            cold = None
            if cold_dir is not None:
                from tpu_resiliency_torch.checkpoint.coldtier import (
                    ColdTier,
                    FilesystemStore,
                )

                cold = ColdTier(
                    FilesystemStore(cold_dir), session=0, rank=rank
                )
            mgr = LocalCheckpointManager(
                root, rank=rank, comm=comm, replication=strat,
                pipelined=pipelined, delta_interval=delta_interval,
                cold=cold if cold is not None else False,
            )
            tree = make_tree(mb, float(rank), dev)
            out = []
            for it in range(1, rounds + 1):
                sd = PyTreeStateDict(
                    _touch_tree(tree, it) if mutate else dict(tree, step=it)
                )
                comm.barrier("round-in")
                t0 = time.perf_counter()
                mgr.save(it, sd)
                fg = time.perf_counter() - t0
                mgr.maybe_finalize(blocking=True)
                e2e = time.perf_counter() - t0
                comm.barrier("round-out")
                out.append((fg, e2e))
            if rank == 0:
                staging_stats.update(mgr.staging.stats())
            if cold is not None:
                # Drain OUTSIDE the timed loop: upload completion is the
                # background worker's business, never the train loop's.
                assert cold.flush(timeout=600.0), "cold uploads did not drain"
                cold.close()
            mgr.close()
            return out
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            per_rank = [
                f.result(timeout=3600.0)
                for f in [pool.submit(body, r) for r in range(world)]
            ]
    finally:
        for s in stores:
            s.close()
        srv.close()
    fg_rounds = [max(t[0] for t in rnd) for rnd in zip(*per_rank)]
    e2e_rounds = [max(t[1] for t in rnd) for rnd in zip(*per_rank)]
    return (
        statistics.median(fg_rounds),
        statistics.median(e2e_rounds),
        staging_stats,
    )


def bench_delta_leg(world: int, mb: int, rounds: int, root: str, device=None) -> dict:
    """Steady-state byte economy: the same clique save loop with
    ``delta_interval`` on and a realistic small per-round mutation. Reports
    the replication bytes a delta round shipped vs the full container a
    mirror round moves (from the save path's own ``ckpt_delta`` events) plus
    the e2e save time."""
    from tpu_resiliency_torch.utils import events as events_mod

    seen = []
    events_mod.add_sink(seen.append)
    try:
        fg, e2e, _ = bench_clique(
            world, mb, rounds, pipelined=True, root=root,
            delta_interval=rounds + 2, mutate=True, device=device,
        )
    finally:
        events_mod.remove_sink(seen.append)
    deltas = [e.payload for e in seen if e.kind == "ckpt_delta"]
    applied = [e.payload for e in seen if e.kind == "ckpt_delta_applied"]
    frame = statistics.median(d["frame_bytes"] for d in deltas)
    full = statistics.median(d["full_bytes"] for d in deltas)
    return {
        "rounds_delta": len(deltas),
        "applied_ok": sum(1 for a in applied if a["outcome"] == "ok"),
        "fg_ms": round(fg * 1e3, 3),
        "e2e_ms": round(e2e * 1e3, 1),
        "frame_bytes": int(frame),
        "full_bytes": int(full),
        #: the ≥5x-fewer-bytes acceptance reads from here
        "bytes_ratio": round(frame / full, 4),
        "bytes_win": round(full / frame, 1),
    }


def bench_cold_leg(world: int, mb: int, rounds: int, root: str, device=None) -> dict:
    """The cold-tier non-interference gate: the same pipelined clique loop
    with and without a durable cold tier attached. Reports both foreground
    medians plus what the spiller archived (from ``coldtier_spilled``
    events) — the acceptance is that ``fg_ms`` is unchanged within noise
    while every keyframe still lands in the object store."""
    from tpu_resiliency_torch.utils import events as events_mod

    base_fg, base_e2e, _ = bench_clique(
        world, mb, rounds, pipelined=True, root=os.path.join(root, "nocold"), device=device
    )
    seen = []
    events_mod.add_sink(seen.append)
    try:
        cold_fg, cold_e2e, _ = bench_clique(
            world, mb, rounds, pipelined=True,
            root=os.path.join(root, "cold"),
            cold_dir=os.path.join(root, "coldstore"), device=device,
        )
    finally:
        events_mod.remove_sink(seen.append)
    spills = [e.payload for e in seen if e.kind == "coldtier_spilled"]
    degraded = [e.payload for e in seen if e.kind == "coldtier_degraded"]
    return {
        "base_fg_ms": round(base_fg * 1e3, 3),
        "cold_fg_ms": round(cold_fg * 1e3, 3),
        "fg_delta_ms": round((cold_fg - base_fg) * 1e3, 3),
        "base_e2e_ms": round(base_e2e * 1e3, 1),
        "cold_e2e_ms": round(cold_e2e * 1e3, 1),
        "spills": len(spills),
        "spilled_bytes": int(sum(p.get("bytes", 0) for p in spills)),
        "degraded": len(degraded),
    }


def cold_foreground_unmoved(cold: dict) -> bool:
    """The cold tier's non-interference gate over a :func:`bench_cold_leg` result:
    attaching the tier leaves the foreground within noise of the run without it (a
    synchronous upload would add the whole container's write time)."""
    return cold["cold_fg_ms"] <= max(cold["base_fg_ms"] * 2.0, cold["base_fg_ms"] + 25.0)


def bench_checkpointer(mb: int, root: str, device=None):
    """Single-rank AsyncCheckpointer foreground: sync engine vs pipelined."""
    out = {}
    for label, pipelined in (("sync", False), ("pipelined", True)):
        ckpt = AsyncCheckpointer(pipelined=pipelined)
        tree = make_tree(mb, 3.0, device)
        fgs = []
        for it in range(3):
            path = os.path.join(root, f"ckpt_{label}_{it}.ckpt")
            t0 = time.perf_counter()
            ckpt.async_save(dict(tree, step=it), path)
            fgs.append(time.perf_counter() - t0)
            ckpt.finalize_all()
        ckpt.close()
        out[f"{label}_fg_ms"] = round(statistics.median(fgs) * 1e3, 3)
    return out


def steady_state_alloc_probe(mb: int, root: str, device=None) -> float:
    """Peak transient host allocation (MB) during a WARM pipelined save —
    the staging-pool claim is that this stays under 1 MB at any tree size."""
    ckpt = AsyncCheckpointer()
    tree = make_tree(mb, 5.0, device)
    for it in range(2):  # warm both double-buffer slots
        ckpt.async_save(dict(tree, step=it), os.path.join(root, f"warm{it}.ckpt"))
        ckpt.finalize_all()
    tracemalloc.start()
    base, _ = tracemalloc.get_traced_memory()
    ckpt.async_save(dict(tree, step=9), os.path.join(root, "steady.ckpt"))
    ckpt.finalize_all()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    ckpt.close()
    return (peak - base) / (1 << 20)


def run_smoke(device=None) -> int:
    """Tiny end-to-end run asserting the spans and metrics appear in the event
    stream, and the delta and cold legs' claims."""
    from tpu_resiliency_torch.utils import events as events_mod
    from tpu_resiliency_torch.utils.metrics import aggregate

    captured = []
    sink = captured.append
    events_mod.add_sink(sink)
    root = tempfile.mkdtemp(prefix="ckpt_save_smoke.")
    try:
        fg, e2e, staging = bench_clique(2, LEAF_MB, 2, pipelined=True, root=root,
                                        device=device)
        records = [
            {"ts": e.ts, "source": e.source, "kind": e.kind, **e.payload}
            for e in captured
        ]
        kinds = {r["kind"] for r in records}
        spans = {
            r.get("span") for r in records if r["kind"] in ("span_begin", "span_end")
        }
        assert "ckpt.save.enqueue" in spans, f"missing enqueue span: {sorted(spans)}"
        assert "ckpt.replicate.fanout" in spans, sorted(spans)
        assert "ckpt_foreground_blocked" in kinds, sorted(kinds)
        assert "staging_pool" in kinds, sorted(kinds)
        assert "ckpt_saved" in kinds, sorted(kinds)
        reg = aggregate(records)
        prom = reg.to_prometheus()
        for metric in (
            "tpu_ckpt_foreground_blocked_seconds",
            "tpu_ckpt_staging_pool_bytes",
            "tpu_ckpt_staging_requests_total",
        ):
            assert metric in prom, f"{metric} missing from aggregated metrics"
        assert staging.get("hits", 0) >= 1, staging
        # Delta steady-state leg: chunk-diff frames ship, apply cleanly, and
        # move a fraction of the container.
        droot = os.path.join(root, "delta")
        delta = bench_delta_leg(2, LEAF_MB, 2, droot, device=device)
        assert delta["rounds_delta"] >= 1, delta
        assert delta["applied_ok"] >= 1, delta
        assert delta["bytes_ratio"] < 0.5, delta
        # Cold-tier non-interference: the spiller must not move the
        # foreground window (within loopback noise — a synchronous upload
        # would add the whole container's write time and fail this by a
        # mile), while every keyframe still lands in the store.
        attempts = []
        for attempt in range(2):  # best of two: a loaded host stalls single saves
            cold = bench_cold_leg(2, LEAF_MB, 2, os.path.join(root, f"coldleg{attempt}"),
                                  device=device)
            assert cold["spills"] >= 2 * 2, cold  # world x rounds keyframes
            assert cold["degraded"] == 0, cold
            attempts.append(cold)
            if cold_foreground_unmoved(cold):
                break
        else:
            raise AssertionError(f"cold tier moved the foreground window: {attempts}")
        print(
            f"bench_ckpt_save smoke OK: fg={fg*1e3:.2f} ms, e2e={e2e*1e3:.1f} ms, "
            f"staging={staging}, delta_ratio={delta['bytes_ratio']}, "
            f"cold_fg_delta={cold['fg_delta_ms']} ms "
            f"({cold['spills']} spills, {cold['spilled_bytes']} B)"
        )
        return 0
    finally:
        events_mod.remove_sink(sink)
        shutil.rmtree(root, ignore_errors=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, nargs="+", default=[256, 1024],
                    help="tree sizes (MiB)")
    ap.add_argument("--world", type=int, default=3, help="clique size")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run asserting the new spans/metrics appear")
    ap.add_argument("--device", default="",
                    help="'cpu' to run on the host; the card by default")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Every size of ``args.mb``, then the single-rank checkpointer and the probe at
    the smallest: the results document."""
    dev = resolve_device(args.device or None)
    sizes = []
    workdir = tempfile.mkdtemp(prefix="bench_ckpt_save.")
    try:
        for mb in args.mb:
            root_s = os.path.join(workdir, f"sync{mb}")
            root_p = os.path.join(workdir, f"pipe{mb}")
            sync_fg, sync_e2e, _ = bench_clique(
                args.world, mb, args.rounds, pipelined=False, root=root_s, device=dev
            )
            pipe_fg, pipe_e2e, staging = bench_clique(
                args.world, mb, args.rounds, pipelined=True, root=root_p, device=dev
            )
            root_d = os.path.join(workdir, f"delta{mb}")
            delta = bench_delta_leg(args.world, mb, args.rounds, root_d, device=dev)
            root_c = os.path.join(workdir, f"cold{mb}")
            cold = bench_cold_leg(args.world, mb, args.rounds, root_c, device=dev)
            sizes.append({
                "mb": mb,
                "sync_fg_ms": round(sync_fg * 1e3, 3),
                "pipelined_fg_ms": round(pipe_fg * 1e3, 3),
                "fg_ratio": round(pipe_fg / sync_fg, 4),
                "sync_e2e_ms": round(sync_e2e * 1e3, 1),
                "pipelined_e2e_ms": round(pipe_e2e * 1e3, 1),
                "staging": staging,
                "delta": delta,
                "cold": cold,
            })
            shutil.rmtree(root_s, ignore_errors=True)
            shutil.rmtree(root_p, ignore_errors=True)
            shutil.rmtree(root_d, ignore_errors=True)
            shutil.rmtree(root_c, ignore_errors=True)
        probe_mb = min(args.mb)
        return {
            "world": args.world,
            "rounds": args.rounds,
            "sizes": sizes,
            "checkpointer_256": bench_checkpointer(
                probe_mb, os.path.join(workdir, "single"), device=dev
            ),
            "steady_state_peak_alloc_mb": round(
                steady_state_alloc_probe(probe_mb, os.path.join(workdir, "probe"), device=dev),
                3,
            ),
            "host": platform.node(),
            "cpus": os.cpu_count(),
            "python": platform.python_version(),
            **device_fields(dev),
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.smoke:
        return run_smoke(args.device or None)
    results = run(args)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
