"""Benchmark clique replication: pickled-blob (v1) vs streaming bulk (v2) path.

Loopback clique of N ranks (threads against one KVServer), each replicating a
shard of ``--mb`` megabytes to every clique peer per round — the exact code
path ``LocalCheckpointManager.save`` drives. Two configurations:

- **old**: ``serialize_to_bytes`` (joined blob) + ``replicate()`` over
  ``PeerExchange(protocol=1)`` — every send pickles ``{"src", "tag", "blob"}``
  into fresh contiguous buffers and the receiver copies the payload again.
- **new**: ``serialize_parts`` + ``replicate_parts()`` over the v2 bulk frames —
  sends scatter-gather the caller's buffers (``sendmsg``), receives land in one
  preallocated buffer (``recv_into``), concurrent peer fan-out.

Also measures peak extra allocation of a single send→recv transfer per path
(``tracemalloc``): the zero-copy claim is ``alloc_ratio_new ≤ 1.25`` (the
receive buffer itself is the 1.0; everything beyond it is protocol overhead).

**Byte-economy legs** (checkpoint/coding/): the same clique re-run under

- **erasure** — ``ErasureReplicationStrategy`` ships one RS block per peer
  (k = world-1, parity 1) instead of whole mirrors: the acceptance claim is
  wire bytes per rank ≤ ``(1 + 1/k)×`` the payload vs the mirror path's
  ``(world-1)×``;
- **delta** — steady-state chunk-diff frames between keyframes (a seeded
  ``--dirty-frac`` fraction of chunks mutated per round): the acceptance
  claim is frame bytes ≤ the dirty fraction (plus manifest overhead) of a
  full container, i.e. ≥5× fewer bytes at small dirty fractions;
- **delta_erasure** — the COMPOSED leg: steady-state delta frames shipped
  through ``ErasureReplicationStrategy`` (one RS block of the frame per
  peer). Wire cost per rank per round is ``frame × (1 + m/k)`` against the
  mirror path's ``full × (world-1)`` — the acceptance claim is a ≥20×
  bytes win at 5% dirty on real payloads, plus byte-identical k-of-n
  reconstruction of the frame from the blocks the surviving peers hold.

    python -m tpu_resiliency_torch.scripts.bench_replication [--mb 256] [--world 3] \
        [--rounds 3] [--dirty-frac 0.05] [--out BENCH_replication.json]
    python -m tpu_resiliency_torch.scripts.bench_replication --smoke   # tiny run, assert the gates
"""

import argparse
import concurrent.futures as cf
import json
import os
import platform
import sys
import time
import tracemalloc

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from tpu_resiliency_torch.checkpoint import format as ckpt_format  # noqa: E402
from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm  # noqa: E402
from tpu_resiliency_torch.checkpoint.replication import CliqueReplicationStrategy  # noqa: E402
from tpu_resiliency_torch.platform.store import CoordStore, KVServer  # noqa: E402


def _payload(mb: int, rank: int):
    """One leaf-per-16MB tree, the shape serialize_parts scatter-gathers."""
    n = mb * (1 << 20)
    leaf = min(n, 16 << 20)
    rng = np.random.default_rng(rank)
    return [rng.integers(0, 255, leaf, dtype=np.uint8) for _ in range(n // leaf)]


def bench_clique(world: int, mb: int, rounds: int, streaming: bool) -> float:
    """Median seconds per replicate round across the clique."""
    srv = KVServer(host="127.0.0.1", port=0)
    stores = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=120.0)
        stores.append(s)
        return s

    proto = None if streaming else 1

    def body(rank):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=120.0)
        ex = PeerExchange(mk(), rank, timeout=120.0, protocol=proto)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world
            )
            tensors = _payload(mb, rank)
            times = []
            for _ in range(rounds):
                comm.barrier("round-in")
                t0 = time.perf_counter()
                if streaming:
                    prefix, views = ckpt_format.serialize_parts(b"hollow", tensors)
                    held = strat.replicate_parts([prefix, *views])
                    assert len(held) == world - 1
                else:
                    blob = ckpt_format.serialize_to_bytes(b"hollow", tensors)
                    held = strat.replicate(blob)
                    assert len(held) == world
                comm.barrier("round-out")
                times.append(time.perf_counter() - t0)
            return times
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            per_rank = [
                f.result(timeout=600.0)
                for f in [pool.submit(body, r) for r in range(world)]
            ]
    finally:
        for s in stores:
            s.close()
        srv.close()
    # A round ends when the slowest rank finishes; barrier timing makes every
    # rank's per-round wall time comparable — take the max across ranks.
    round_times = [max(ts) for ts in zip(*per_rank)]
    return sorted(round_times)[len(round_times) // 2]


def bench_alloc(mb: int, streaming: bool) -> float:
    """Peak extra allocation of ONE send→recv transfer, as a multiple of the
    payload size. Serial phases (send fully buffered by the kernel? no — run
    the send on a thread while the receiver drains) under tracemalloc."""
    srv = KVServer(host="127.0.0.1", port=0)
    stores = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=60.0)
        stores.append(s)
        return s

    proto = None if streaming else 1
    nbytes = mb * (1 << 20)
    tensors = _payload(mb, 0)
    exs = []
    try:
        for rank in (0, 1):
            ex = PeerExchange(mk(), rank, timeout=60.0, protocol=proto)
            ex.start()
            exs.append(ex)
        prefix, views = ckpt_format.serialize_parts(b"hollow", tensors)
        tracemalloc.start()
        base, _ = tracemalloc.get_traced_memory()
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            if streaming:
                fut = pool.submit(exs[0].send_parts, 1, "t", [prefix, *views])
            else:
                blob = b"".join([prefix, *[bytes(v) for v in views]])
                fut = pool.submit(exs[0].send, 1, "t", blob)
            got = exs[1].recv(0, "t", timeout=60.0)
            fut.result()
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        # Container = prefix + payload + v2 integrity trailer.
        assert memoryview(got).cast("B").nbytes == ckpt_format.parts_nbytes(
            prefix, views
        )
        return (peak - base) / nbytes
    finally:
        for ex in exs:
            ex.close()
        for s in stores:
            s.close()
        srv.close()


def bench_erasure(world: int, mb: int, rounds: int) -> dict:
    """Erasure replication round: median seconds + wire bytes per rank per
    round (from the strategy's own ``ckpt_parity`` accounting)."""
    from tpu_resiliency_torch.checkpoint.coding import ErasureReplicationStrategy
    from tpu_resiliency_torch.utils import events as tpu_events

    seen = []
    tpu_events.add_sink(seen.append)
    srv = KVServer(host="127.0.0.1", port=0)
    stores = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=120.0)
        stores.append(s)
        return s

    def body(rank):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=120.0)
        ex = PeerExchange(mk(), rank, timeout=120.0)
        ex.start()
        try:
            strat = ErasureReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world,
                parity=1,
            )
            tensors = _payload(mb, rank)
            times = []
            for _ in range(rounds):
                comm.barrier("round-in")
                t0 = time.perf_counter()
                prefix, views = ckpt_format.serialize_parts(b"hollow", tensors)
                held = strat.replicate_parts([prefix, *views])
                assert len(held) == world - 1
                comm.barrier("round-out")
                times.append(time.perf_counter() - t0)
            return times
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            per_rank = [
                f.result(timeout=600.0)
                for f in [pool.submit(body, r) for r in range(world)]
            ]
    finally:
        tpu_events.remove_sink(seen.append)
        for s in stores:
            s.close()
        srv.close()
    round_times = [max(ts) for ts in zip(*per_rank)]
    parity = [e.payload for e in seen if e.kind == "ckpt_parity"]
    payload = max(p["payload_bytes"] for p in parity)
    sent = max(p["sent_bytes"] for p in parity)
    k = parity[0]["k"]
    return {
        "round_s": round(sorted(round_times)[len(round_times) // 2], 4),
        "k": k,
        "m": parity[0]["m"],
        "payload_bytes": payload,
        "sent_bytes_per_rank": sent,
        #: the acceptance ratio: wire bytes per rank / payload (mirror = world-1)
        "payload_ratio": round(sent / payload, 4),
        "mirror_payload_ratio": world - 1,
    }


def bench_delta(world: int, mb: int, rounds: int, dirty_frac: float) -> dict:
    """Steady-state delta replication: keyframe round 0, then ``rounds``
    chunk-diff rounds with ``dirty_frac`` of each shard's chunks mutated —
    the exact wire path ``LocalCheckpointManager.save`` ships between
    keyframes. Reports frame bytes vs the full container bytes a mirror
    round moves."""
    from tpu_resiliency_torch.checkpoint.coding import delta as delta_mod

    srv = KVServer(host="127.0.0.1", port=0)
    stores = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=120.0)
        stores.append(s)
        return s

    stats_out: dict = {}

    def body(rank):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=120.0)
        ex = PeerExchange(mk(), rank, timeout=120.0)
        ex.start()
        try:
            strat = CliqueReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world
            )
            tensors = _payload(mb, rank)
            rng = np.random.default_rng(rank + 99)
            # Keyframe: full mirror round seeds every peer's base.
            comm.barrier("kf-in")
            prefix, views = ckpt_format.serialize_parts(b"hollow", tensors)
            strat.replicate_parts([prefix, *views])
            comm.barrier("kf-out")
            info = ckpt_format.parse_trailer_v3(views[-1])
            leaf_sizes = [v.nbytes for v in views[:-1]]
            base = {
                "iteration": 0,
                "leaf_sizes": leaf_sizes,
                "chunk_size": info.chunk_size,
                "leaf_chunks": info.leaf_chunk_crcs(leaf_sizes),
                "container_crc": info.container_crc,
            }
            times, frames, fulls = [], [], []
            for it in range(1, rounds + 1):
                cs = info.chunk_size
                for t in tensors:  # mutate dirty_frac of each leaf's chunks
                    nchunks = max(1, t.nbytes // cs)
                    for c in range(nchunks):
                        if rng.random() < dirty_frac:
                            t[c * cs] ^= 0xFF
                comm.barrier("d-in")
                t0 = time.perf_counter()
                prefix, views = ckpt_format.serialize_parts(b"hollow", tensors)
                frame, st = delta_mod.encode_delta(
                    rank, it, base, prefix, views[:-1], bytes(views[-1])
                )
                strat.replicate_parts([frame])
                comm.barrier("d-out")
                times.append(time.perf_counter() - t0)
                frames.append(st["frame_bytes"])
                fulls.append(st["full_bytes"])
                leaf_sizes = [v.nbytes for v in views[:-1]]
                info2 = ckpt_format.parse_trailer_v3(views[-1])
                base = {
                    "iteration": it,
                    "leaf_sizes": leaf_sizes,
                    "chunk_size": info2.chunk_size,
                    "leaf_chunks": info2.leaf_chunk_crcs(leaf_sizes),
                    "container_crc": info2.container_crc,
                }
            if rank == 0:
                stats_out.update(
                    frame_bytes=int(np.median(frames)),
                    full_bytes=int(np.median(fulls)),
                )
            return times
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            per_rank = [
                f.result(timeout=600.0)
                for f in [pool.submit(body, r) for r in range(world)]
            ]
    finally:
        for s in stores:
            s.close()
        srv.close()
    round_times = [max(ts) for ts in zip(*per_rank)]
    frame_b, full_b = stats_out["frame_bytes"], stats_out["full_bytes"]
    return {
        "round_s": round(sorted(round_times)[len(round_times) // 2], 4),
        "dirty_frac": dirty_frac,
        "frame_bytes": frame_b,
        "full_bytes": full_b,
        #: the acceptance ratio: delta wire bytes / full-mirror wire bytes
        "bytes_ratio": round(frame_b / full_b, 4),
        "bytes_win": round(full_b / frame_b, 1),
    }


def bench_delta_erasure(world: int, mb: int, rounds: int,
                        dirty_frac: float) -> dict:
    """The COMPOSED byte-economy leg: steady-state delta frames between
    keyframes, each frame itself SHIPPED erasure-coded — one RS block per
    peer instead of whole-frame mirrors. The wire cost per round is
    ``frame_bytes × (1 + m/k)`` against the mirror path's
    ``full_bytes × (world-1)``, which is where the two planes multiply.

    Also proves the resilience side of the claim on the REAL wire
    artifacts: the blocks the peers hold after the last round (k of n —
    the source rank and its local block presumed lost) reconstruct the
    delta frame byte-identically through the production
    ``reconstruct_container`` fences."""
    from tpu_resiliency_torch.checkpoint.coding import (
        ErasureReplicationStrategy,
        delta as delta_mod,
        strategy as ec_strategy,
    )
    from tpu_resiliency_torch.utils import events as tpu_events

    seen = []
    tpu_events.add_sink(seen.append)
    srv = KVServer(host="127.0.0.1", port=0)
    stores = []

    def mk():
        s = CoordStore("127.0.0.1", srv.port, timeout=120.0)
        stores.append(s)
        return s

    stats_out: dict = {}

    def body(rank):
        comm = StoreComm(mk(), rank, list(range(world)), timeout=120.0)
        ex = PeerExchange(mk(), rank, timeout=120.0)
        ex.start()
        try:
            strat = ErasureReplicationStrategy(
                comm, ex, replication_jump=1, replication_factor=world,
                parity=1,
            )
            tensors = _payload(mb, rank)
            rng = np.random.default_rng(rank + 99)
            comm.barrier("kfe-in")
            prefix, views = ckpt_format.serialize_parts(b"hollow", tensors)
            strat.replicate_parts([prefix, *views])
            comm.barrier("kfe-out")
            info = ckpt_format.parse_trailer_v3(views[-1])
            leaf_sizes = [v.nbytes for v in views[:-1]]
            base = {
                "iteration": 0,
                "leaf_sizes": leaf_sizes,
                "chunk_size": info.chunk_size,
                "leaf_chunks": info.leaf_chunk_crcs(leaf_sizes),
                "container_crc": info.container_crc,
            }
            times, frames, fulls = [], [], []
            held = []
            frame = b""
            for it in range(1, rounds + 1):
                cs = info.chunk_size
                for t in tensors:
                    nchunks = max(1, t.nbytes // cs)
                    for c in range(nchunks):
                        if rng.random() < dirty_frac:
                            t[c * cs] ^= 0xFF
                comm.barrier("de-in")
                t0 = time.perf_counter()
                prefix, views = ckpt_format.serialize_parts(b"hollow", tensors)
                frame, st = delta_mod.encode_delta(
                    rank, it, base, prefix, views[:-1], bytes(views[-1])
                )
                held = strat.replicate_parts([frame])
                comm.barrier("de-out")
                times.append(time.perf_counter() - t0)
                frames.append(st["frame_bytes"])
                fulls.append(st["full_bytes"])
                leaf_sizes = [v.nbytes for v in views[:-1]]
                info2 = ckpt_format.parse_trailer_v3(views[-1])
                base = {
                    "iteration": it,
                    "leaf_sizes": leaf_sizes,
                    "chunk_size": info2.chunk_size,
                    "leaf_chunks": info2.leaf_chunk_crcs(leaf_sizes),
                    "container_crc": info2.container_crc,
                }
            if rank == 0:
                stats_out.update(
                    frame_bytes=int(np.median(frames)),
                    full_bytes=int(np.median(fulls)),
                    last_frame=bytes(frame),
                )
            return times, held
        finally:
            ex.close()

    try:
        with cf.ThreadPoolExecutor(max_workers=world) as pool:
            per_rank = [
                f.result(timeout=600.0)
                for f in [pool.submit(body, r) for r in range(world)]
            ]
    finally:
        tpu_events.remove_sink(seen.append)
        for s in stores:
            s.close()
        srv.close()
    round_times = [max(ts) for ts in zip(*[ts for ts, _ in per_rank])]
    frame_b, full_b = stats_out["frame_bytes"], stats_out["full_bytes"]

    # Per-round wire accounting off the strategy's own ckpt_parity events;
    # the keyframe round codes the full container, the steady-state rounds
    # code frames a fraction of its size — split on payload size.
    parity = [e.payload for e in seen if e.kind == "ckpt_parity"]
    kf_payload = max(p["payload_bytes"] for p in parity)
    delta_rounds = [p for p in parity if p["payload_bytes"] < kf_payload / 2]
    assert delta_rounds, "no delta-coded rounds observed"
    k = delta_rounds[0]["k"]
    m = delta_rounds[0]["m"]
    payload = max(p["payload_bytes"] for p in delta_rounds)
    sent = max(p["sent_bytes"] for p in delta_rounds)

    # k-of-n reconstruction of rank 0's LAST frame from the blocks its
    # peers actually hold (source rank dead, its local block lost with it).
    want_frame = stats_out["last_frame"]
    survivors_blocks = []
    for _, held in per_rank[1:]:
        art = held.get(0)
        if art is None:
            continue
        header, _ = ec_strategy.parse_block(art)
        assert header.get("payload") == "delta", header
        survivors_blocks.append(art)
    assert len(survivors_blocks) >= k, (
        f"peers hold {len(survivors_blocks)} of rank 0's frame blocks, "
        f"need k={k}"
    )
    rebuilt = ec_strategy.reconstruct_container(
        survivors_blocks[:k], source="bench-delta-erasure"
    )
    assert rebuilt == want_frame, (
        "k-of-n reconstructed delta frame is NOT byte-identical"
    )

    return {
        "round_s": round(sorted(round_times)[len(round_times) // 2], 4),
        "dirty_frac": dirty_frac,
        "k": k,
        "m": m,
        "frame_bytes": frame_b,
        "full_bytes": full_b,
        #: wire bytes per rank per round / the frame payload (≤ 1 + m/k)
        "payload_ratio": round(sent / payload, 4),
        #: composed win: full-mirror round bytes / coded delta round bytes
        "bytes_win": round((full_b * (world - 1)) / sent, 1),
        "reconstruct_ok": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=256, help="shard size per rank (MiB)")
    ap.add_argument("--world", type=int, default=3, help="clique size")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dirty-frac", type=float, default=0.05,
                    help="fraction of chunks mutated per delta round")
    ap.add_argument("--alloc-mb", type=int, default=None,
                    help="payload for the allocation probe (default: --mb)")
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run asserting the byte-economy gates, exit 0/1")
    args = ap.parse_args(argv)

    if args.smoke:
        args.mb, args.world, args.rounds = 8, 3, 2
        args.alloc_mb = 2

    # Bytes exchanged per round: every rank sends its shard to world-1 peers.
    exchanged = args.world * (args.world - 1) * args.mb * (1 << 20)

    old_s = bench_clique(args.world, args.mb, args.rounds, streaming=False)
    new_s = bench_clique(args.world, args.mb, args.rounds, streaming=True)
    alloc_mb = args.alloc_mb or args.mb
    alloc_old = bench_alloc(alloc_mb, streaming=False)
    alloc_new = bench_alloc(alloc_mb, streaming=True)
    erasure = bench_erasure(args.world, args.mb, args.rounds)
    delta = bench_delta(args.world, args.mb, args.rounds, args.dirty_frac)
    delta_erasure = bench_delta_erasure(
        args.world, args.mb, args.rounds, args.dirty_frac
    )

    results = {
        "world": args.world,
        "payload_mb": args.mb,
        "rounds": args.rounds,
        "old_round_s": round(old_s, 4),
        "new_round_s": round(new_s, 4),
        "old_mbps": round(exchanged / old_s / 1e6, 1),
        "new_mbps": round(exchanged / new_s / 1e6, 1),
        "speedup": round(old_s / new_s, 2),
        "alloc_probe_mb": alloc_mb,
        "alloc_ratio_old": round(alloc_old, 3),
        "alloc_ratio_new": round(alloc_new, 3),
        "erasure": erasure,
        "delta": delta,
        "delta_erasure": delta_erasure,
        "host": platform.node(),
        "python": platform.python_version(),
    }
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    if args.smoke:
        k = erasure["k"]
        ce_k = delta_erasure["k"]
        # bytes_win at full scale must clear 20× (the 5%-dirty composed
        # claim); the smoke payload is tiny so manifest overhead dominates —
        # gate the composition mechanics (coded ratio + reconstruction)
        # there, and still require a material win over plain mirroring.
        ok = (
            erasure["payload_ratio"] <= (1 + 1 / k) + 0.05
            and erasure["payload_ratio"] < erasure["mirror_payload_ratio"]
            and delta["bytes_ratio"] < 0.5
            and delta_erasure["payload_ratio"] <= (1 + 1 / ce_k) + 0.05
            and delta_erasure["bytes_win"] >= 2.0
            and delta_erasure["reconstruct_ok"]
        )
        print(f"bench_replication smoke: {'PASS' if ok else 'FAIL'} "
              f"(erasure ratio {erasure['payload_ratio']} vs mirror "
              f"{erasure['mirror_payload_ratio']}; delta ratio "
              f"{delta['bytes_ratio']}; composed win "
              f"{delta_erasure['bytes_win']}x ratio "
              f"{delta_erasure['payload_ratio']})")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
