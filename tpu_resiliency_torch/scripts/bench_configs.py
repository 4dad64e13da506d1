"""BASELINE configs 1-3 replay harnesses on the card (config 4 lives in ``bench.py``).

Port of ``scripts/bench_configs.py``: the same three harnesses, seeds, keys and files,
on the port's modules.

- **Config 1**: 64-rank section-timing report (per-section relative scores =
  min-of-medians / local median, total-time weighting, 0.75 threshold), scored by
  ``ReportGenerator.generate_summary_report`` on the seeded 64 x 3 medians, weights
  and counts as tensors on the card.
- **Config 2**: 256-rank heartbeat replay with one injected hang through the monitor's
  decision code (``RankMonitorServer._hb_timeout_elapsed``) on a virtual clock; host
  code, as in the reference.
- **Config 3**: 1024 ranks x 16 signals x window 32 with 5% slow ranks, scored by
  ``scoring.score_round`` with its window reduction from
  ``ops.scoring_kernels.fused_median_weights`` (the ``loop`` kernel on the card),
  ``ewma`` threaded round to round. On the card its medians are held bit for bit, as
  int32, against the sort path's (``scoring.masked_median``).

Usage::

    python -m tpu_resiliency_torch.scripts.bench_configs [--out-dir DIR] [--iters N] \\
        [--configs 1,2,3] [--device cpu]

Prints one JSON line per config and writes ``BENCH_config{N}.json`` and
``BENCH_configs.json`` to the out dir (the checkout's ``build/`` by default). Each line
carries ``backend``, ``device_kind`` and ``card``. Config 1's ``report_ms`` is the
host's clock over the whole report, as the reference's (its device span beside it,
``report_events_ms``, on CUDA events); config 3's ``report_ms`` is a device span, on
CUDA events on the card and the host's clock on the CPU (``timer``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from tpu_resiliency_torch.scripts import DEFAULT_OUT_DIR, SpanTimer, device_fields


def f1(pred: set, truth: set) -> float:
    tp = len(pred & truth)
    fp = len(pred - truth)
    fn = len(truth - pred)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


# ---------------------------------------------------------------------------
# Config 1: 64-rank section-timing report parity
# ---------------------------------------------------------------------------

def config1_inputs():
    """The seeded medians, weights and counts (numpy), the section names and the slow
    ranks: the reference's, from ``default_rng(1)``."""
    ranks, sections = 64, 3
    names = ("sec/fwd", "sec/bwd", "sec/opt")
    slow = {17}
    rng = np.random.default_rng(1)
    base = rng.uniform(0.010, 0.030, size=(1, sections))
    medians = np.tile(base, (ranks, 1)) * (
        1.0 + 0.02 * rng.standard_normal((ranks, sections))
    )
    for r in slow:
        medians[r] *= 2.0
    weights = medians * 100.0  # total time over ~100 samples
    counts = np.full((ranks, sections), 100, np.int32)
    return medians, weights, counts, names, slow


def config1(iters: int, dev, detail=None) -> dict:
    """Config 1's line; ``detail``, a dict, also gets the last ``report``."""
    import torch

    from tpu_resiliency_torch.telemetry.reporting import ReportGenerator

    medians, weights, counts, names, slow = config1_inputs()
    ranks, sections = medians.shape
    gen = ReportGenerator(world_size=ranks, max_signals=sections, device=dev)
    # float32 on the device, as jnp.asarray gives the reference's float64 inputs
    m, w = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (medians, weights))
    c = torch.tensor(counts, device=dev)
    report = gen.generate_summary_report(m, w, c, names)  # warm
    t0 = time.perf_counter()
    with SpanTimer(dev) as span:
        for _ in range(iters):
            report = gen.generate_summary_report(m, w, c, names)
    report_ms = (time.perf_counter() - t0) / iters * 1e3

    stragglers = report.identify_stragglers(perf_threshold=0.75)
    flagged = {s.rank for s in stragglers.by_perf}
    # Reference-semantics parity checks (examples/straggler): healthy ranks score
    # ~1.0, the slow rank scores ~min/median = ~0.5 and is flagged.
    healthy = [v for r, v in report.perf_scores.items() if r not in slow]
    parity = (
        min(healthy) > 0.9
        and max(healthy) <= 1.0 + 1e-6
        and report.perf_scores[17] < 0.6
    )
    out = {
        "config": 1,
        "ranks": ranks,
        "report_ms": round(report_ms, 4),
        "f1": round(f1(flagged, slow), 4),
        "flagged": sorted(flagged),
        "parity_semantics_ok": bool(parity),
        "report_events_ms": span.ms / iters if span.cuda else None,
        "report_timer": "host_clock",
    }
    if detail is not None:
        detail["report"] = report
    return out


# ---------------------------------------------------------------------------
# Config 2: 256-rank heartbeat replay, one injected hang
# ---------------------------------------------------------------------------

def config2(_: int, dev=None) -> dict:
    from tpu_resiliency_torch.watchdog.config import FaultToleranceConfig
    from tpu_resiliency_torch.watchdog.data import RankInfo
    from tpu_resiliency_torch.watchdog.monitor_server import RankMonitorServer, _RankSession

    ranks = 256
    hang_rank = 101
    hb_interval = 1.0
    hb_timeout = 3.0
    check_interval = 0.5
    hang_at = 30.0
    horizon = 60.0

    cfg = FaultToleranceConfig(
        initial_rank_heartbeat_timeout=10.0,
        rank_heartbeat_timeout=hb_timeout,
        workload_check_interval=check_interval,
    )
    servers = []
    for r in range(ranks):
        srv = RankMonitorServer(cfg, socket_path=f"/nonexistent/replay_{r}.sock")
        srv.session = _RankSession(
            info=RankInfo(global_rank=r, local_rank=r % 8, host=f"host{r // 8}", pid=0),
            connected_at=0.0,
        )
        servers.append(srv)

    detected: dict[int, float] = {}
    scan_times = []
    now = 0.0
    while now < horizon:
        now = round(now + check_interval, 6)
        # Replay heartbeats that arrived since the last tick (virtual clock).
        for r, srv in enumerate(servers):
            last_beat = None
            t = hb_interval
            while t <= now:
                if not (r == hang_rank and t >= hang_at):
                    last_beat = t
                t += hb_interval
            srv.session.last_hb = last_beat
        # The real decision code, timed: one full 256-rank scan per tick.
        t0 = time.perf_counter()
        for r, srv in enumerate(servers):
            if r in detected:
                continue
            reason = srv._hb_timeout_elapsed(now)
            if reason is not None:
                detected[r] = now
        scan_times.append(time.perf_counter() - t0)

    truth = {hang_rank}
    pred = set(detected)
    # Latency from the hang (last heartbeat the rank would have sent) to the tick
    # that flagged it. Expected: hb_timeout .. hb_timeout + hb_interval + tick.
    last_hb_sent = hang_at - hb_interval
    latency = (
        round(detected[hang_rank] - last_hb_sent, 3) if hang_rank in detected else None
    )
    return {
        "config": 2,
        "ranks": ranks,
        "hang_rank": hang_rank,
        "detection_latency_s": latency,
        "latency_budget_s": hb_timeout + hb_interval + check_interval,
        "f1": round(f1(pred, truth), 4),
        "scan_us_per_tick": round(float(np.mean(scan_times)) * 1e6, 2),
        "detected": {str(r): t for r, t in sorted(detected.items())},
    }


# ---------------------------------------------------------------------------
# Config 3: 1024-rank kernel-timing stream, 5% slow nodes
# ---------------------------------------------------------------------------

def config3_inputs():
    """The seeded ``[R, S, W]`` float32 windows, counts and slow ranks: the
    reference's, from ``default_rng(3)``."""
    ranks, signals, window = 1024, 16, 32
    rng = np.random.default_rng(3)
    base = rng.uniform(0.8, 1.2, size=(1, signals, 1)).astype(np.float32)
    data = base * (1.0 + 0.05 * rng.standard_normal((ranks, signals, window)).astype(np.float32))
    n_slow = ranks // 20  # 5%
    slow = set(rng.choice(ranks, size=n_slow, replace=False).tolist())
    for r in slow:
        data[r] *= 1.6
    counts = np.full((ranks, signals), window, np.int32)
    return data, counts, slow


def config3(iters: int, dev, detail=None) -> dict:
    """Config 3's line; ``detail``, a dict, also gets the last round's ``scores`` and
    the kernel's ``medians``."""
    import torch

    from tpu_resiliency_torch.ops import scoring_kernels as sk
    from tpu_resiliency_torch.telemetry import scoring

    data, counts, slow = config3_inputs()
    ranks, signals, window = data.shape
    d = torch.tensor(data, device=dev)
    c = torch.tensor(counts, device=dev)
    ewma = torch.ones(ranks, device=dev)
    hist = torch.full((ranks, signals), float("inf"), device=dev)

    last = {}

    def round_(prev_ewma):
        last["mw"] = sk.fused_median_weights(d, c)
        return scoring.score_round(None, c, prev_ewma, hist, medians_and_weights=last["mw"])

    before = dict(sk.fused_median_weights.launches_by_mode)
    out = round_(ewma)  # warm
    with SpanTimer(dev) as span:
        for _ in range(iters):
            out = round_(out.ewma)
    report_ms = span.ms / iters
    launches = {m: n - before[m] for m, n in sk.fused_median_weights.launches_by_mode.items()}

    # The last round's medians against the sort path's, bit for bit as int32 (the
    # sort path launches no kernel).
    kernel_medians = last["mw"][0]
    sort_medians = scoring.masked_median(d, c)
    medians_equal = bool(torch.equal(kernel_medians.view(torch.int32),
                                     sort_medians.view(torch.int32)))

    pred = set(np.nonzero(out.straggler.cpu().numpy())[0].tolist())
    if detail is not None:
        detail.update(scores=out, medians=kernel_medians)
    return {
        "config": 3,
        "ranks": ranks,
        "slow_fraction": 0.05,
        "report_ms": round(report_ms, 4),
        "f1": round(f1(pred, slow), 4),
        "signals": signals,
        "window": window,
        "iters": iters,
        "timer": span.timer,
        "kernel_mode": sk.auto_mode(window),
        "launches": launches,
        "medians_equal_sort_path_int32": medians_equal,
        "flagged": len(pred),
    }


RUNNERS = {1: config1, 2: config2, 3: config3}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--configs", default="1,2,3")
    ap.add_argument("--device", default="",
                    help="'cpu' to run on the host; the card by default")
    return ap.parse_args(argv)


def run(args) -> dict[int, dict]:
    """Every config of ``args.configs``: ``{n: result}``, each result with the device
    fields; writes the files and prints one line per config."""
    from tpu_resiliency_torch.platform.device import resolve_device

    dev = resolve_device(args.device or None)
    os.makedirs(args.out_dir, exist_ok=True)
    combined_path = os.path.join(args.out_dir, "BENCH_configs.json")
    combined = {}
    if os.path.exists(combined_path):
        # A partial --configs rerun refreshes only its own entries; the other
        # configs' previously measured results stay in the artifact.
        try:
            with open(combined_path) as f:
                combined = json.load(f)
        except (OSError, ValueError):
            combined = {}
    fields = device_fields(dev)
    combined.update(fields)
    combined["note"] = (
        "configs 1-3 are host-semantic detection benchmarks (section "
        "report, heartbeat replay, timing-stream scoring); config 1's report_ms "
        "is host-side, config 3's a device span on CUDA events on the card; F1 is "
        "backend-independent"
    )
    results = {}
    for n in (int(x) for x in args.configs.split(",")):
        result = {**RUNNERS[n](args.iters, dev), **fields}
        line = json.dumps(result)
        print(line, flush=True)
        with open(os.path.join(args.out_dir, f"BENCH_config{n}.json"), "w") as f:
            f.write(line + "\n")
        combined[f"config{n}"] = result
        results[n] = result
    with open(combined_path, "w") as f:
        json.dump(combined, f, indent=1)
        f.write("\n")
    return results


def main(argv=None) -> int:
    results = run(parse_args(argv))
    return 0 if all(r["f1"] >= 1.0 for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
