"""Benchmark elastic reshard: ranged peer fetch vs full-mirror retrieve.

The scenario is the elastic headline: a 4-rank dp world checkpoints with
layout meta, loses rank 3, and the 3 survivors resume resharded. Two ways to
move the bytes a survivor newly owns:

- **ranged** (`LocalCheckpointManager.load_resharded`): fetch ONLY the byte
  ranges of the source shards the target rank's new blocks intersect, over
  the `PeerExchange.fetch_ranges` wire op (per-range CRCs).
- **full-mirror** (what the pre-reshard code forced): every needed source
  container is retrieved WHOLE from a holder, then sliced locally — the
  shape of `CliqueReplicationStrategy.retrieve`.

Both paths run against the same on-disk root over loopback; the report
records wall time and the peer bytes each moved. The interesting number is
``bytes_ratio`` (ranged / full): the ranged path must move strictly fewer
bytes — at this scenario's geometry roughly half a shard instead of whole
containers — and the committed run is the regression anchor for
``tests/checkpoint/test_reshard_perf.py``.

The committed artifact also carries a ``leg_1g`` block (``--with-1g``): the
same scenario at a 1 GB tree, where fixed costs (collectives, plan build)
vanish into the noise and the speedup is pure serve-path pipelining — the
1 GB speedup must EXCEED the 64 MB one, which is the regression gate that
the overlap keeps scaling with payload instead of being a small-payload
artifact. ``--assert-subsecond`` turns the report into a pass/fail check of
the elastic headline: shrink-to-trainable (the slowest survivor's
``load_resharded`` wall) under one second at the gate payload.

    python -m tpu_resiliency_torch.scripts.bench_reshard [--mb 64] [--with-1g] [--out BENCH_reshard.json]
"""

import argparse
import concurrent.futures as cf
import json
import os
import platform
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tpu_resiliency_torch.checkpoint import reshard as R  # noqa: E402
from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm  # noqa: E402
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager  # noqa: E402
from tpu_resiliency_torch.checkpoint.replication import CliqueReplicationStrategy  # noqa: E402
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict  # noqa: E402
from tpu_resiliency_torch.platform.store import CoordStore, KVServer  # noqa: E402
from tpu_resiliency_torch.scripts import DEFAULT_OUT_DIR  # noqa: E402
from tpu_resiliency_torch.utils import events as tpu_events  # noqa: E402

WORLD = [0, 1, 2, 3]
SURVIVORS = [0, 1, 2]


def _layout(mb: int):
    # One dp-sharded tree of ~mb MB total: a handful of [rows, 4096] f32
    # leaves, rows divisible by 4 so the saved world is uniform.
    total = mb << 20
    leaf_bytes = min(total, 16 << 20)
    nleaves = max(1, total // leaf_bytes)
    rows = leaf_bytes // (4096 * 4)
    rows -= rows % 4
    leaves = [R.LeafSpec((rows, 4096), "float32", ("dp",)) for _ in range(nleaves)]
    return R.TreeLayout([("dp", 4)], WORLD, leaves)


def _local_tree(layout, rank):
    tree = {}
    for i, spec in enumerate(layout.leaves):
        shape = layout.box(i, rank).shape
        rng = np.random.default_rng(rank * 1000 + i)
        # Zero-padded keys: pytrees flatten in sorted-key order, which must
        # match the layout's leaf order (save() validates this).
        tree[f"leaf{i:03d}"] = rng.standard_normal(shape).astype(np.float32)
    tree["step"] = 1
    return tree


def _run_world(ranks, fn, timeout=600):
    with cf.ThreadPoolExecutor(max_workers=len(ranks)) as pool:
        return [f.result(timeout=timeout) for f in [pool.submit(fn, r) for r in ranks]]


def bench(mb: int) -> dict:
    layout = _layout(mb)
    srv = KVServer(host="127.0.0.1", port=0)
    root = tempfile.mkdtemp(prefix="bench_reshard.")
    stores = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=120.0)
        stores.append(s)
        return s

    def save_body(rank):
        comm = StoreComm(mk(), rank, WORLD, timeout=120.0)
        ex = PeerExchange(mk(), rank, timeout=120.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=2
            )
            mgr = LocalCheckpointManager(root, rank=rank, comm=comm, replication=strat)
            mgr.save(
                1, PyTreeStateDict(_local_tree(layout, rank)),
                is_async=False, layout=layout,
            )
            mgr.close()
        finally:
            ex.close()

    _run_world(WORLD, save_body)

    seen = []
    tpu_events.add_sink(seen.append)

    # -- ranged path -------------------------------------------------------
    def ranged_body(rank):
        comm = StoreComm(mk(), rank, SURVIVORS, timeout=120.0, generation=1)
        ex = PeerExchange(mk(), rank, timeout=120.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=2
            )
            mgr = LocalCheckpointManager(root, rank=rank, comm=comm, replication=strat)
            t0 = time.perf_counter()
            hollow, tensors, meta = mgr.load_resharded()
            dt = time.perf_counter() - t0
            mgr.close()
            return dt, sum(t.nbytes for t in tensors)
        finally:
            ex.close()

    ranged = _run_world(SURVIVORS, ranged_body)
    ranged_s = max(dt for dt, _ in ranged)
    ranged_peer = sum(
        e.payload["bytes"] for e in seen
        if e.kind == "reshard_fetch" and e.payload.get("via") == "peer"
    )
    ranged_local = sum(
        e.payload["bytes"] for e in seen
        if e.kind == "reshard_fetch" and e.payload.get("via") == "local"
    )

    # -- full-mirror baseline ---------------------------------------------
    # Same END STATE as the ranged path (the target-local tree assembled in
    # host memory), but bytes move the way pre-reshard recovery forced:
    # every source container a rank cannot serve locally is fetched WHOLE
    # (all leaves, full ranges) from a holder, local sources are read WHOLE
    # off disk, and the target blocks are then sliced out of the complete
    # containers in memory.
    source = layout
    target = source.retarget(SURVIVORS)
    plan = R.build_plan(source, target)

    def full_body(rank):
        comm = StoreComm(mk(), rank, SURVIVORS, timeout=120.0, generation=2)
        ex = PeerExchange(mk(), rank, timeout=120.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=2
            )
            mgr = LocalCheckpointManager(root, rank=rank, comm=comm, replication=strat)
            held = {i.owner for i in mgr.local_ids() if i.iteration == 1}
            all_held = comm.all_gather((rank, sorted(held)), tag="bench-held")
            holders = {r: set(h) for r, h in all_held}
            rp = plan.for_rank(rank)
            needed = set()
            for seg in rp.segments:
                if not (set(seg.owners) & held):
                    needed.add(sorted(seg.owners)[0])
            t0 = time.perf_counter()
            moved = 0
            # Whole-container sources: peer mirrors over the wire, held
            # containers off disk (leaf payloads via full-range reads).
            sources: dict[int, list] = {}
            for owner in sorted(needed):
                holder = min(r for r, h in holders.items() if owner in h and r != rank)
                full = [
                    [i, 0, source.local_nbytes(i, owner)]
                    for i in range(len(source.leaves))
                ]
                _, parts = ex.fetch_ranges(
                    holder,
                    {"session": 0, "iteration": 1, "owner": owner, "ranges": full},
                )
                moved += sum(memoryview(p).nbytes for p in parts)
                sources[owner] = parts
            for seg in rp.segments:
                owner = min(set(seg.owners) & held, default=None)
                if owner is not None and owner not in sources:
                    full = [
                        [i, 0, source.local_nbytes(i, owner)]
                        for i in range(len(source.leaves))
                    ]
                    sources[owner] = mgr._read_ranges(1, owner, full)
            # Assemble the same target-local leaves the ranged path built.
            buffers = [
                np.empty(shape, dtype=np.float32)
                for shape in rp.local_shapes
            ]
            flats = [b.reshape(-1).view(np.uint8) for b in buffers]
            for seg in rp.segments:
                owner = min(o for o in seg.owners if o in sources)
                for rg in seg.ranges:
                    leaf_buf = memoryview(sources[owner][seg.leaf])
                    flats[seg.leaf][rg.dst_off : rg.dst_off + rg.nbytes] = (
                        np.frombuffer(
                            leaf_buf[rg.src_off : rg.src_off + rg.nbytes],
                            dtype=np.uint8,
                        )
                    )
            dt = time.perf_counter() - t0
            comm.barrier(tag="bench-full-done")
            mgr.close()
            return dt, moved
        finally:
            ex.close()

    full = _run_world(SURVIVORS, full_body)
    full_s = max(dt for dt, _ in full)
    full_peer = sum(moved for _, moved in full)
    tpu_events.remove_sink(seen.append)

    # Phase decomposition from the SAME event stream, through the same code
    # path tpu-critpath runs for operators (tools/critpath.py) — no more
    # bench-private stopwatch arithmetic.
    from tpu_resiliency_torch.tools.critpath import reshard_decomposition

    phases = reshard_decomposition([e.to_record() for e in seen])

    for s in stores:
        s.close()
    srv.close()
    import shutil

    shutil.rmtree(root, ignore_errors=True)

    return {
        "host": platform.node(),
        "world": len(WORLD),
        "shrink_to": len(SURVIVORS),
        "mb": mb,
        "ranged_s": round(ranged_s, 4),
        "ranged_peer_bytes": ranged_peer,
        "ranged_local_bytes": ranged_local,
        #: tools/critpath.py:reshard_decomposition over the run's events —
        #: plan-build vs ranged-fetch wall split (fetch_s is the serve-side
        #: target ROADMAP item 4 attacks)
        "phases": phases,
        "full_s": round(full_s, 4),
        "full_peer_bytes": full_peer,
        "bytes_ratio": round(ranged_peer / full_peer, 4) if full_peer else None,
        "speedup": round(full_s / ranged_s, 2) if ranged_s else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mb", type=int, default=64, help="total tree size (MB)")
    ap.add_argument("--out", default=os.path.join(DEFAULT_OUT_DIR, "BENCH_reshard.json"),
                    help="write the JSON report here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny payload, assert the bytes win, exit 0/1")
    ap.add_argument("--with-1g", action="store_true",
                    help="also run the slow 1 GB leg (leg_1g in the report); "
                    "its speedup must exceed the gate payload's")
    ap.add_argument("--assert-subsecond", action="store_true",
                    help="exit 1 unless shrink-to-trainable (ranged_s) < 1 s")
    args = ap.parse_args(argv)
    mb = 2 if args.smoke else args.mb
    res = bench(mb)
    if args.with_1g:
        res["leg_1g"] = bench(1024)
    print(json.dumps(res, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
            f.write("\n")
    rc = 0
    if args.smoke:
        ok = (
            res["full_peer_bytes"] > 0
            and res["ranged_peer_bytes"] < res["full_peer_bytes"]
        )
        print(f"bench_reshard smoke: {'PASS' if ok else 'FAIL'}")
        rc = max(rc, 0 if ok else 1)
    if args.assert_subsecond:
        ok = res["ranged_s"] < 1.0
        print(
            f"bench_reshard sub-second resume: shrink-to-trainable "
            f"{res['ranged_s']}s at {mb} MB — {'PASS' if ok else 'FAIL'}"
        )
        rc = max(rc, 0 if ok else 1)
    if args.with_1g:
        ok = (res["leg_1g"]["speedup"] or 0) > (res["speedup"] or 0)
        print(
            f"bench_reshard 1G scaling: speedup {res['leg_1g']['speedup']}x "
            f"@1G vs {res['speedup']}x @{mb}MB — {'PASS' if ok else 'FAIL'}"
        )
        rc = max(rc, 0 if ok else 1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
