"""Measure single-stream vs N-way fan-out checkpoint writes (fsync'd, warm,
alternating runs) — the measurement behind checkpoint/format.py's single-stream
design decision. Re-run on new storage before changing the writer topology.

    python -m tpu_resiliency_torch.scripts.bench_ckpt_io [--gib 1] [--ways 1,4] [--dir DIR]
"""
import argparse
import concurrent.futures as cf
import os
import tempfile
import time

import numpy as np


def write_one(path, data):
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def bench(blob, n_ways, d):
    size = len(blob)
    chunk = size // n_ways
    parts = [blob[i * chunk:(i + 1) * chunk] for i in range(n_ways)]
    paths = [os.path.join(d, f"part{i}.bin") for i in range(n_ways)]
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(n_ways) as ex:
        list(ex.map(write_one, paths, parts))
    dt = time.perf_counter() - t0
    for p in paths:
        os.unlink(p)
    return dt


def bench_payload(arrays, stripes, d):
    """The PRODUCT write path (format.write_payload), striped vs sequential —
    what $TPU_RESILIENCY_CKPT_STRIPES actually controls."""
    from tpu_resiliency_torch.checkpoint import format as ckpt_format

    path = os.path.join(d, "payload.ckpt")
    t0 = time.perf_counter()
    ckpt_format.write_payload(path, b"hollow", arrays, stripes=stripes)
    dt = time.perf_counter() - t0
    os.unlink(path)
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--ways", default="1,4")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    size = int(args.gib * (1 << 30))
    ways = [int(w) for w in args.ways.split(",")]
    blob = np.random.default_rng(0).integers(0, 255, size, dtype=np.uint8).tobytes()
    # 64 leaves of 1/64th each: the leaf-count shape write_payload stripes over.
    # Views into the one blob (bytes slicing would copy and double peak memory).
    leaf = size // 64
    full = np.frombuffer(blob, dtype=np.uint8)
    arrays = [full[i * leaf:(i + 1) * leaf] for i in range(64)]
    with tempfile.TemporaryDirectory(dir=args.dir) as d:
        bench(blob, 1, d)  # warm the page cache / allocator
        results = {w: [] for w in ways}
        payload_results = {w: [] for w in ways}
        for _ in range(args.rounds):
            for w in ways:
                results[w].append(bench(blob, w, d))
                payload_results[w].append(bench_payload(arrays, w, d))
        for label, res in (("raw fan-out", results), ("write_payload", payload_results)):
            for w, ts in res.items():
                med = sorted(ts)[len(ts) // 2]
                print(
                    f"{label} {w}-way: {min(ts):.2f}-{max(ts):.2f}s, median {med:.2f}s "
                    f"({size / med / 1e9:.2f} GB/s)"
                )


if __name__ == "__main__":
    main()
