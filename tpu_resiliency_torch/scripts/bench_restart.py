"""Recovery-latency benchmark: in-process restart vs in-job respawn, measured.

Port of ``scripts/bench_restart.py``: the same four legs, options and keys, on the
port's ``inprocess.Wrapper``, launcher and rendezvous.

- **In-process engine latency** (world 2, ranks in fresh interpreters): a rank's fn
  raises; the latency is fault → fn re-entry on the SAME process, covering quiesce,
  abort, finalize, health check, iteration barrier, and rank reassignment. Measured
  on the faulting rank and on the healthy peer. The ranks' fn touches no device, as
  the reference's does not. The reference forks its ranks; these are spawned, since
  a fork of a process that ran CUDA and NCCL work (the caller's) may never reach the
  Wrapper.
- **In-job respawn latency** (the port's launcher, 2 workers): a worker exits
  nonzero; the latency is worker exit → re-spawned worker's entry, decomposed from the
  launcher's own event stream by ``tools/critpath.py`` ``restart_decomposition`` into
  detect / teardown / rendezvous / spawn and startup (cold) or promote and first step
  ready (warm spares, parked with ``--warm-spare-warmup runtime``).
- **Fast-path rendezvous micro-bench**: N simulated agents on loopback run
  replacement rounds with the full open/join/close ladder vs the single-CAS
  round-reuse fast path.
- **Compile-cache restart leg**: a worker under ``--compile-cache-dir``
  ``torch.compile``s ``tanh(x @ x.T).sum()`` on a 256 x 256 float32 on the card and
  crashes once; round 1 must record a cache **hit** (Inductor's and Triton's caches,
  swept and manifested by ``platform/compile_cache.py``) and a cheaper compile. The
  compiled function is the worker's own program, not a port of a TPU kernel.

Usage::

    python -m tpu_resiliency_torch.scripts.bench_restart [--restarts N] [--out FILE] \\
        [--smoke] [--device cpu]

Prints one JSON line per layer and writes ``BENCH_restart.json`` (to the checkout's
``build/`` by default). Every line carries ``backend``, ``device_kind`` and ``card``.
The latencies are host spans, on the host's clock as the reference's; the compile
leg's compile times end with the result read back from the card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

from tpu_resiliency_torch.scripts import DEFAULT_OUT_DIR, device_fields

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ---------------------------------------------------------------- in-process --


def _inproc_rank(rank: int, port: int, n_restarts: int, q) -> None:
    os.environ.update(
        RANK=str(rank),
        WORLD_SIZE="2",
        TPU_RESILIENCY_STORE_PORT=str(port),
        TPU_RESILIENCY_STORE_HOST="127.0.0.1",
    )
    from tpu_resiliency_torch.inprocess.wrap import CallWrapper, Wrapper

    fault_times: list[float] = []
    entry_times: list[float] = []

    @Wrapper(
        monitor_interval=0.05,
        last_call_wait=0.1,
        soft_timeout=30.0,
        hard_timeout=60.0,
        heartbeat_interval=0.2,
        heartbeat_timeout=20.0,
        barrier_timeout=60.0,
        completion_timeout=60.0,
    )
    def train(call: CallWrapper):
        entry_times.append(time.monotonic())
        if call.iteration < n_restarts:
            if rank == 0:
                time.sleep(0.05)  # let the peer enter its fn before the fault
                fault_times.append(time.monotonic())
                raise RuntimeError(f"bench fault {call.iteration}")
            # Healthy peer: park until the engine interrupts us.
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                time.sleep(0.01)
            return "peer-timeout"
        return "done"

    result = train()
    q.put((rank, result, fault_times, entry_times))


def bench_inprocess(n_restarts: int) -> dict:
    from tpu_resiliency_torch.platform.distributed import reserve_port

    port, held = reserve_port()  # rank 0's store binds it; held until the ranks are done
    ctx = mp.get_context("spawn")  # safe from a caller that holds CUDA or NCCL state
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_inproc_rank, args=(r, port, n_restarts, q))
        for r in range(2)
    ]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + 120
    while len(out) < 2 and time.monotonic() < deadline:
        try:
            rank, result, faults, entries = q.get(timeout=1.0)
            out[rank] = (result, faults, entries)
        except Exception:
            if not any(p.is_alive() for p in procs) and q.empty():
                break  # every rank is gone: nothing more will come
    for p in procs:
        p.join(20.0)
        if p.is_alive():
            p.terminate()
    held.close()
    assert [out.get(r, (None,))[0] for r in range(2)] == ["done", "done"], (
        out, [p.exitcode for p in procs])

    _, faults, entries0 = out[0]
    _, _, entries1 = out[1]
    # Faulting rank: fault i happens in iteration i; re-entry is entries[i+1].
    own = [entries0[i + 1] - faults[i] for i in range(n_restarts)]
    # Healthy peer: its re-entry i+1 measured from the same fault instant.
    peer = [entries1[i + 1] - faults[i] for i in range(n_restarts)]
    return {
        "restarts": n_restarts,
        "faulting_rank_ms": {
            "median": sorted(own)[len(own) // 2] * 1e3,
            "min": min(own) * 1e3,
            "max": max(own) * 1e3,
        },
        "healthy_peer_ms": {
            "median": sorted(peer)[len(peer) // 2] * 1e3,
            "min": min(peer) * 1e3,
            "max": max(peer) * 1e3,
        },
        "startup_to_first_entry_s": entries0[0] - t0,
    }


# ------------------------------------------------------------------- in-job --

# Round 0 rank 0: optionally wait for a warm spare (deterministic promotion —
# detection+rendezvous are now fast enough that an immediate crash can beat
# the spare's own warm-up), stamp the fault instant, exit 1. Round 1: stamp
# re-entry.
WORKER = """
import glob, os, sys, time
stamp_dir = sys.argv[1]
spares_glob = sys.argv[2] if len(sys.argv) > 2 else ""
count = int(os.environ.get("TPU_FT_RESTART_COUNT", "0"))
with open(os.path.join(stamp_dir, f"entry_{count}_{os.environ['RANK']}"), "w") as f:
    f.write(repr(time.time()))
if count == 0 and os.environ["RANK"] == "0":
    if spares_glob:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            ready = [p for p in glob.glob(spares_glob) if not p.endswith(".tmp")]
            if ready:
                break
            time.sleep(0.02)
        else:
            sys.exit(17)  # spare never went warm: fail loudly, not flakily
    with open(os.path.join(stamp_dir, "exit_0"), "w") as f:
        f.write(repr(time.time()))
    sys.exit(1)
time.sleep(0.5)
"""


def bench_injob(warm_spares: int = 0, fast_path: bool = True) -> dict:
    """Respawn latency, decomposed from the launcher's own structured event
    stream by ``tools/critpath.py:restart_decomposition`` — the SAME code
    path ``python -m tpu_resiliency_torch.tools.critpath`` runs for operators,
    anchored here at the worker's own fault/re-entry stamps (same wall clock as
    the stream):

    - ``detect_ms``: fault injection (the worker's exit stamp) →
      ``failure_detected`` (the supervise loop's ``wait_change`` return).
    - ``teardown_ms``: ``failure_detected`` → ``restart_requested`` (failure
      records, hang census, worker-group stop).
    - ``rendezvous_ms``: ``restart_requested`` → the replacement
      ``rendezvous_round`` (fast path: one CAS + barrier; ladder otherwise).
    - ``promote_ms`` / ``first_step_ready_ms``: round placed →
      ``worker_promoted`` → the promoted worker's first Python statement
      (cold runs report the combined segment as ``spawn_and_startup_ms``).

    The interpreter startup tax is measured separately as a median-of-3 floor
    with the same env."""
    env = _env()
    floors = []
    for _ in range(3):
        t0 = time.monotonic()
        subprocess.run([sys.executable, "-c", "pass"], env=env, check=True)
        floors.append((time.monotonic() - t0) * 1e3)
    startup_ms = sorted(floors)[1]

    with tempfile.TemporaryDirectory() as td:
        worker = os.path.join(td, "worker.py")
        with open(worker, "w") as f:
            f.write(WORKER)
        stamps = os.path.join(td, "stamps")
        os.makedirs(stamps)
        events = os.path.join(td, "events.jsonl")
        run_dir = os.path.join(td, "run")
        argv = [
            sys.executable, "-m", "tpu_resiliency_torch.launcher.launch",
            "--nproc-per-node", "2", "--max-restarts", "2",
            # Private ephemeral store: the default endpoint port may be
            # transiently occupied by unrelated jobs/tests on this host.
            "--rdzv-endpoint", "127.0.0.1:0",
            "--monitor-interval", "0.1",
            "--events-file", events,
            "--run-dir", run_dir,
            "--warm-spares", str(warm_spares),
            "--warm-spare-preload", "json",
            "--warm-spare-warmup", "runtime" if warm_spares else "imports",
        ]
        if not fast_path:
            argv.append("--no-rdzv-fast-path")
        argv.append(worker)
        argv.append(stamps)
        if warm_spares:
            argv.append(os.path.join(run_dir, "spares", "ready_*"))
        proc = subprocess.run(
            argv, env=env, capture_output=True, text=True, timeout=180, cwd=td,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]

        def read(name):
            with open(os.path.join(stamps, name)) as f:
                return float(f.read())

        from tpu_resiliency_torch.tools.critpath import restart_decomposition

        evs = [json.loads(line) for line in open(events)]
        t_exit = read("exit_0")
        t_reentry = read("entry_1_0")
        dec = restart_decomposition(evs, fault_ts=t_exit, resume_ts=t_reentry)
        assert dec is not None, "no restart episode in the event stream"
        segs = {s["name"]: s["duration_ms"] for s in dec["segments"]}
        out = {
            "respawn_ms": (t_reentry - t_exit) * 1e3,
            "detect_ms": segs["detect"],
            "teardown_ms": segs["teardown"],
            "rendezvous_ms": segs["rendezvous"],
            "fast_path_rendezvous": dec["fast_path"],
            "python_startup_floor_ms": startup_ms,
        }
        if warm_spares:
            assert dec["promoted"], "warm leg never promoted a spare"
            out["promote_ms"] = segs["promote"]
            # Clamped: the promoted shim starts executing the instant the spec
            # hits its pipe, which can beat the launcher's own event stamp by
            # a fraction of a millisecond.
            out["first_step_ready_ms"] = max(0.0, segs["first_step_ready"])
        else:
            out["spawn_and_startup_ms"] = segs["spawn_and_startup"]
        return out


# -------------------------------------------------- fast-path rendezvous ----


def bench_rendezvous_fastpath(nodes: int = 16, rounds: int = 8) -> dict:
    """Replacement-round latency, full ladder vs fast path: N simulated agents
    on one loopback store run ``rounds`` restart rounds per mode; the figure
    is the wall time from the restart request until EVERY agent is placed."""
    from tpu_resiliency_torch.launcher.rendezvous import (
        RendezvousSettings,
        StoreRendezvous,
    )
    from tpu_resiliency_torch.platform.store import CoordStore, KVServer

    server = KVServer(host="127.0.0.1", port=0)
    try:

        def run_mode(fast: bool) -> list[float]:
            prefix = f"bench_{'fast' if fast else 'ladder'}/"
            stores, rdzvs = [], []
            for i in range(nodes):
                st = CoordStore("127.0.0.1", server.port, prefix=prefix)
                rdzvs.append(
                    StoreRendezvous(
                        st, f"n{i}",
                        RendezvousSettings(
                            min_nodes=nodes, max_nodes=nodes,
                            last_call_timeout=0.3,
                            keep_alive_interval=0.1, keep_alive_timeout=10.0,
                            poll_interval=0.05, fast_path=fast,
                        ),
                    )
                )
                stores.append(st)

            def place_all(prev: int) -> None:
                errs: list = []

                def run(r):
                    try:
                        r.next_round(prev)
                    except Exception as e:
                        errs.append(e)

                ts = [threading.Thread(target=run, args=(r,)) for r in rdzvs]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(30.0)
                assert not errs, errs

            place_all(-1)
            times = []
            for rnd in range(rounds):
                rdzvs[0].request_restart(f"bench {rnd}")
                t0 = time.monotonic()
                place_all(rnd)
                times.append((time.monotonic() - t0) * 1e3)
            for r in rdzvs:
                r.stop_keepalive()
            for s in stores:
                s.close()
            return times

        ladder = run_mode(False)
        fast = run_mode(True)
        return {
            "nodes": nodes,
            "rounds": rounds,
            "full_ladder_ms": {
                "median": statistics.median(ladder),
                "min": min(ladder), "max": max(ladder),
            },
            "fast_path_ms": {
                "median": statistics.median(fast),
                "min": min(fast), "max": max(fast),
            },
            "speedup": statistics.median(ladder) / statistics.median(fast),
        }
    finally:
        server.close()


# ------------------------------------------------------- compile cache ------

JIT_WORKER = """
import json, os, sys, time
# One kernel to compile: in this process, as JAX compiles, not in a pool of compile
# workers (each a fresh interpreter importing torch, in both rounds, hit or miss).
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
from tpu_resiliency_torch.platform import device
device.apply_platform_env()  # applies the compile cache + records its event
import torch
import torch._dynamo, torch._inductor.compile_fx  # the compiler's imports, untimed as jax's
dev = device.resolve_device(sys.argv[2] or None)
count = int(os.environ.get("TPU_FT_RESTART_COUNT", "0"))
x = torch.ones((256, 256), dtype=torch.float32, device=dev)
t0 = time.monotonic()
f = torch.compile(lambda x: torch.tanh(x @ x.T).sum())
float(f(x))  # the compile, the call and the read back
jit_ms = (time.monotonic() - t0) * 1e3
with open(os.path.join(sys.argv[1], f"jit_{count}.json"), "w") as fh:
    json.dump({"jit_ms": jit_ms}, fh)
if count == 0:
    sys.exit(1)
"""


def bench_compile_cache(device=None) -> dict:
    """A compiling worker crashes once; the replacement round must find the
    persistent compilation cache warm (outcome=hit) and compile cheaper. ``device``:
    the worker's (the card by default; ``"cpu"`` compiles with the host's C++
    compiler instead of Triton)."""
    from tpu_resiliency_torch.platform import compile_cache

    env = _env()
    with tempfile.TemporaryDirectory() as td:
        worker = os.path.join(td, "worker.py")
        with open(worker, "w") as f:
            f.write(JIT_WORKER)
        stamps = os.path.join(td, "stamps")
        os.makedirs(stamps)
        events = os.path.join(td, "events.jsonl")
        cache_dir = os.path.join(td, "compile_cache")
        proc = subprocess.run(
            [
                sys.executable, "-m", "tpu_resiliency_torch.launcher.launch",
                "--standalone", "--nproc-per-node", "1", "--max-restarts", "2",
                "--no-ft-monitors", "--monitor-interval", "0.1",
                "--events-file", events,
                "--compile-cache-dir", cache_dir,
                "--run-dir", os.path.join(td, "run"),
                worker, stamps, device or "",
            ],
            env=env, capture_output=True, text=True, timeout=300, cwd=td,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        evs = [json.loads(line) for line in open(events)]
        cc = [e for e in evs if e.get("kind") == "compile_cache"]
        assert len(cc) >= 2, cc
        outcomes = [e["outcome"] for e in cc]
        manifest = compile_cache.read_manifest(cache_dir)

        def read(name):
            return json.load(open(os.path.join(stamps, name)))

        return {
            "first_jit_ms": read("jit_0.json")["jit_ms"],
            "restart_jit_ms": read("jit_1.json")["jit_ms"],
            "outcomes": outcomes,
            "restart_hit": outcomes[-1] == "hit",
            "cache_bytes": cc[-1].get("bytes", 0),
            "manifest_entries": {d: sum(1 for n in manifest if n.startswith(f"{d}/"))
                                 for d in ("inductor", "triton")},
        }


# -------------------------------------------------------------------- main --


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--restarts", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(DEFAULT_OUT_DIR, "BENCH_restart.json"))
    ap.add_argument(
        "--smoke", action="store_true",
        help="reduced-rep sanity pass for CI: runs every leg once and asserts "
        "the structural claims (promotion, fast path, cache hit) without "
        "writing the bench file",
    )
    ap.add_argument("--device", default="",
                    help="'cpu' to run on the host; the card by default")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from tpu_resiliency_torch.platform.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device or None)
    fields = device_fields(dev)

    def emit(layer, rec):
        print(json.dumps({"layer": layer, **rec, **fields}), flush=True)

    if args.smoke:
        injob_warm = bench_injob(warm_spares=2)
        emit("in-job-warm", injob_warm)
        assert injob_warm["fast_path_rendezvous"], "fast-path rendezvous not taken"
        assert "promote_ms" in injob_warm, "no promotion on the warm path"
        fastpath = bench_rendezvous_fastpath(nodes=2, rounds=2)
        emit("rendezvous-fastpath", fastpath)
        cache = bench_compile_cache(args.device or None)
        emit("compile-cache", cache)
        assert cache["restart_hit"], cache
        print(json.dumps({"bench_restart_smoke": "PASS", **fields}))
        return 0

    inproc = bench_inprocess(args.restarts)
    emit("in-process", inproc)
    injob = bench_injob()
    emit("in-job", injob)
    injob_warm = bench_injob(warm_spares=2)
    emit("in-job-warm", injob_warm)
    fastpath = bench_rendezvous_fastpath()
    emit("rendezvous-fastpath", fastpath)
    cache = bench_compile_cache(args.device or None)
    emit("compile-cache", cache)

    summary = summarize(inproc, injob, injob_warm, fastpath, cache)
    summary.update(fields)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({
        "metric": "recovery latency: in-process engine (median, faulting rank) vs in-job respawn",
        "in_process_ms": round(inproc["faulting_rank_ms"]["median"], 1),
        "in_job_ms": round(injob["respawn_ms"], 1),
        "in_job_warm_ms": round(injob_warm["respawn_ms"], 1),
        "speedup": round(summary["speedup_in_process_vs_in_job"], 1),
        "fastpath_rendezvous_speedup": round(fastpath["speedup"], 2),
        "compile_cache_restart_hit": cache["restart_hit"],
        **fields,
    }))
    return 0


def summarize(inproc, injob, injob_warm, fastpath, cache) -> dict:
    """``BENCH_restart.json``'s document, the reference's keys."""
    median = inproc["faulting_rank_ms"]["median"]
    return {
        "in_process": inproc,
        "in_job": injob,
        "in_job_warm_spares": injob_warm,
        "rendezvous_fastpath": fastpath,
        "compile_cache": cache,
        "speedup_in_process_vs_in_job": injob["respawn_ms"] / median,
        "warm_spare_respawn_speedup": injob["respawn_ms"] / injob_warm["respawn_ms"],
        "warm_vs_in_process_ratio": injob_warm["respawn_ms"] / median,
    }


if __name__ == "__main__":
    sys.exit(main())
