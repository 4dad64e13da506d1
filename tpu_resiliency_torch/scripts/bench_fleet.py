"""Benchmark fleet federation: scrape cost vs job count + crash containment.

The fleet acceptance story, measured: N concurrent 2-rank chaos jobs (each a
real `tpu-ft-launcher --standalone --fleet-dir ...` run on loopback whose
rank 0 faults once in round 0, so every job exercises a restart while being
scraped) registered in one fleet dir, with a fleetd aggregator scraping them.
Each job's workers train ``examples/resilient_training.py`` (a step every
``STEP_S``) on ``--device``: the card by default, ``cpu`` for the host.

Two gates:

- **sub-linear scrape cost**: one scrape fans out in parallel, so its wall
  clock tracks the slowest job, not the sum — p95 scrape time at the largest
  fleet must come in well under the linear extrapolation from the smallest
  (`p95_max < p95_min * (N_max/N_min) * SUBLINEAR_FACTOR`).
- **crash containment**: SIGKILL one whole job (launcher + workers, the
  process group) while the scrape loop keeps running; every `/fleet/*`
  endpoint must keep answering 200 with the dead job reported `unreachable`.

The committed run is BENCH_fleet.json, regression-anchored by the
slow-marked ``tests/fleet/test_fleet_perf.py``.

    python -m tpu_resiliency_torch.scripts.bench_fleet [--sizes 2,4,8] [--scrapes 20] \
        [--out BENCH_fleet.json] [--device cpu]
    python -m tpu_resiliency_torch.scripts.bench_fleet --smoke
"""

import argparse
import json
import os
import platform
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tpu_resiliency_torch.fleet.aggregator import FleetAggregator  # noqa: E402
from tpu_resiliency_torch.fleet.server import FleetServer  # noqa: E402

#: the sub-linear bar: p95 at the largest fleet vs linear extrapolation from
#: the smallest — 0.75 means "at least 25% better than linear", comfortably
#: cleared by parallel fan-out (near-flat) yet robust to loopback noise
SUBLINEAR_FACTOR = 0.75

FLEET_ENDPOINTS = (
    "/fleet/metrics", "/fleet/goodput", "/fleet/slo", "/fleet/incidents",
    "/fleet/hangz", "/fleet/snapshot",
)

#: The jobs' workers: ``examples/resilient_training.py`` at a small width, paced
#: as the reference's worker is (a step every ``STEP_S``), crashing once in round 0
#: on rank 0 at ``FAULT_STEP`` and stopping once the run's stop file appears, or at
#: the latest after ``STEPS``, the reference worker's 180 s deadline.
STEP_S = 0.25
FAULT_STEP = 5
STEPS = FAULT_STEP + int(180 / STEP_S)
WORKER_WIDTHS = ("--ranks", "64", "--signals", "8", "--window", "8", "--report-every", "20",
                 "--ckpt-every", "20")


def launch_job(workdir: str, fleet_dir: str, idx: int, device: str) -> subprocess.Popen:
    job_dir = os.path.join(workdir, f"job{idx}")
    os.makedirs(job_dir, exist_ok=True)
    # One process group per job so the SIGKILL leg kills launcher AND workers
    # in one shot — the way a node loss would.
    return subprocess.Popen(
        [
            sys.executable, "-m", "tpu_resiliency_torch.launcher.launch",
            "--standalone", "--nproc-per-node", "2", "--max-restarts", "2",
            "--rdzv-last-call", "0.2",
            "--monitor-interval", "0.1",
            "--rdzv-id", f"bench-job-{idx}",
            "--fleet-dir", fleet_dir,
            "--events-file", os.path.join(job_dir, "events.jsonl"),
            "--run-dir", os.path.join(job_dir, "run"),
            "-m", "tpu_resiliency_torch.examples.resilient_training",
            *(["--device", device] if device else []), *WORKER_WIDTHS,
            "--steps", str(STEPS), "--step-time", str(STEP_S), "--fault-step", str(FAULT_STEP),
            "--stop-file", os.path.join(workdir, "stop"),
            "--ckpt-dir", os.path.join(job_dir, "ckpt"),
        ],
        stdout=open(os.path.join(job_dir, "launcher.log"), "w"),
        stderr=subprocess.STDOUT,
        start_new_session=True,
        env={
            **os.environ,
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        },
    )


def wait_reachable(agg: FleetAggregator, want: int, deadline_s: float = 90.0):
    deadline = time.time() + deadline_s
    ok: list = []
    while time.time() < deadline:
        view = agg.scrape()
        ok = [s for s in view.states if s["reachable"]]
        if len(ok) >= want:
            return view
        time.sleep(0.3)
    raise RuntimeError(
        f"only {len(ok)} of {want} jobs became scrapeable in {deadline_s}s"
    )


def measure_size(agg: FleetAggregator, scrapes: int) -> dict:
    times = []
    jobs = None
    for _ in range(scrapes):
        t0 = time.monotonic()
        view = agg.scrape()
        times.append(time.monotonic() - t0)
        jobs = len(view.states)
    times.sort()
    return {
        "jobs": jobs,
        "scrapes": scrapes,
        "p50_s": round(times[len(times) // 2], 6),
        "p95_s": round(times[min(len(times) - 1, int(len(times) * 0.95))], 6),
        "max_s": round(times[-1], 6),
    }


def run(sizes, scrapes, workdir: str, device: str = "") -> dict:
    fleet_dir = os.path.join(workdir, "fleet")
    os.makedirs(fleet_dir, exist_ok=True)
    agg = FleetAggregator(fleet_dir, timeout=5.0)
    procs: list[subprocess.Popen] = []
    results: list[dict] = []
    kill_report: dict = {}
    try:
        for size in sizes:
            while len(procs) < size:
                procs.append(launch_job(workdir, fleet_dir, len(procs), device))
            wait_reachable(agg, size)
            for _ in range(3):  # warmup: compile caches, lazy imports settle
                agg.scrape()
            res = measure_size(agg, scrapes)
            print(f"  {res['jobs']} jobs: p50={res['p50_s'] * 1e3:.1f}ms "
                  f"p95={res['p95_s'] * 1e3:.1f}ms")
            results.append(res)

        # -- crash containment: SIGKILL one job's whole process group while
        # the fleet endpoint keeps serving.
        srv = FleetServer(agg, port=0, scrape_ttl=0.0)
        port = srv.start()
        try:
            victim = procs[0]
            os.killpg(os.getpgid(victim.pid), signal.SIGKILL)
            victim.wait(timeout=30)
            statuses: dict = {}
            rows: dict = {}
            deadline = time.time() + 30
            dead_job = "bench-job-0"
            while time.time() < deadline:
                statuses = {}
                for ep in FLEET_ENDPOINTS:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{ep}", timeout=15
                    ) as r:
                        statuses[ep] = r.status
                doc = json.load(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/fleet/goodput", timeout=15))
                rows = {r["job"]: r["status"] for r in doc["jobs"]}
                if rows.get(dead_job) == "unreachable":
                    break
                time.sleep(0.3)
            kill_report = {
                "victim": dead_job,
                "endpoint_status": statuses,
                "all_200": all(s == 200 for s in statuses.values()),
                "victim_status": rows.get(dead_job),
                "survivors_ok": all(
                    st == "ok" for j, st in rows.items() if j != dead_job
                ),
            }
            print(f"  kill leg: endpoints={sorted(set(statuses.values()))} "
                  f"victim={kill_report['victim_status']}")
        finally:
            srv.stop()
    finally:
        with open(os.path.join(workdir, "stop"), "w"):
            pass
        # Each worker leads its own session, so a signal to its launcher's group does not
        # reach it: let the workers end on the stop file (their launchers exit with them)
        # before the work directory, and the file, go away.
        deadline = time.time() + 30
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        for p in procs:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGTERM)
            except (OSError, ProcessLookupError):
                pass
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass
        # A killed launcher's workers outlive it (the SIGKILL leg's job): end every
        # process left whose command line names this run's stop file.
        stop = os.path.join(workdir, "stop").encode()
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    if stop in f.read():
                        os.kill(int(pid), signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass

    lo, hi = results[0], results[-1]
    linear = lo["p95_s"] * (hi["jobs"] / lo["jobs"])
    sublinear = {
        "p95_low_s": lo["p95_s"],
        "p95_high_s": hi["p95_s"],
        "jobs_low": lo["jobs"],
        "jobs_high": hi["jobs"],
        "linear_extrapolation_s": round(linear, 6),
        "factor_vs_linear": round(hi["p95_s"] / linear, 6) if linear else None,
        "bar": SUBLINEAR_FACTOR,
        "ok": hi["p95_s"] < linear * SUBLINEAR_FACTOR,
    }
    return {
        "bench": "fleet_federation",
        "host": platform.node(),
        "python": sys.version.split()[0],
        "config": {"sizes": list(sizes), "scrapes": scrapes,
                   "nproc_per_node": 2, "device": device or "cuda"},
        "scrape_cost": results,
        "sublinear": sublinear,
        "kill": kill_report,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", default=None,
                    help="comma-separated fleet sizes (default 2,4,8)")
    ap.add_argument("--scrapes", type=int, default=None,
                    help="timed scrapes per size (default 20)")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes, few scrapes — the CI smoke leg")
    ap.add_argument("--device", default="",
                    help="the workers' device: 'cpu' for the host; the card by default")
    args = ap.parse_args(argv)
    if args.smoke:
        sizes = [2, 4] if args.sizes is None else [
            int(s) for s in args.sizes.split(",")]
        scrapes = args.scrapes or 8
    else:
        sizes = [int(s) for s in (args.sizes or "2,4,8").split(",")]
        scrapes = args.scrapes or 20
    with tempfile.TemporaryDirectory(prefix="bench_fleet_") as workdir:
        print(f"fleet bench: sizes={sizes}, {scrapes} scrapes/size "
              f"({workdir})")
        res = run(sizes, scrapes, workdir, args.device)
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    ok = res["sublinear"]["ok"] and res["kill"].get("all_200") \
        and res["kill"].get("victim_status") == "unreachable"
    if not ok:
        print("FAIL: fleet acceptance gates not met", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
