#!/usr/bin/env python3
"""Drive the PyTorch port's straggler-telemetry hot loop on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA card
and the CUDA toolkit (``nvcc``), builds the port's kernels from the checkout's
sources, and runs these phases, each printing one JSON line that carries the card's
name and power limit:

1. ``device``: the card, its count, and ``nvidia-smi``'s name and power limit.
2. ``build``: the kernel build's seconds and ptxas register / shared-memory / spill lines.
3. ``kernel_vs_plain``: the median/weight kernel against its plain PyTorch version on
   the card, at 4096 ranks x 64 signals x window 32 (the ring's permuted view and a
   contiguous copy, random counts in [0, W]) and at edge windows W in
   {1, 7, 32, 128, 256} with ties, all-equal windows, negative values and counts 0
   and 1. Medians must be equal bit for bit; weights within 1e-5 of the window's
   sum of absolute values (f32 sums taken in another order).
4. ``main_path``: ``MeshTelemetry`` at 4096 x 64 x 32 on the card, fed the seeded
   telemetry of ``bench.py`` (5% slow ranks at 1.6x): W pushes, a report, W + 5
   more pushes (the ring wraps), a second report. The kernel's launch count must
   rise; the straggler mask must equal the sort path's on the card and the plain
   path's on the CPU; F1 against the seeded truth is printed.
5. ``times``: CUDA-event times after a warm-up at 4096 x 64 x 32, L2 flushed before
   each timed reduction: push per step, score per report, the kernel, its plain
   version, the sort-based masked median + total, and ``torch.nanquantile`` +
   ``torch.nansum`` as the library yardstick (never called by the port).
6. ``breakdown``: ``torch.profiler`` device time by kernel over a few reports.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; without a
CUDA card, or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

R, S, W = 4096, 64, 32
SLOW_FRACTION = 0.05
SLOWDOWN = 1.6
EDGE_WINDOWS = (1, 7, 32, 128, 256)
EDGE_RANKS = EDGE_SIGNALS = 64
WEIGHT_RTOL = 1e-5  # of the window's sum of |x|: reordered f32 sums, W <= 256
REPORT_INTERVAL = 100  # steps per report for the amortised per-step cost
# H100 SXM published peaks (NVIDIA data sheet), used for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_FLUSH_BYTES = 64 << 20  # larger than the 50 MB L2

KERNEL = {
    "name": "median_weights_loop",
    "route": "cuda",
    "source": "tpu_resiliency_torch/csrc/median_weights.cu",
    "replaces": "tpu_resiliency/ops/scoring_pallas.py:42",
}


def make_telemetry(seed=0):
    """``bench.py``'s seeded config-4 telemetry: windows [R, S, W], full counts, and
    the truth mask of the slow ranks."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.8, 1.2, size=(1, S, 1)).astype(np.float32)
    data = base * (1.0 + 0.05 * rng.standard_normal((R, S, W)).astype(np.float32))
    n_slow = int(R * SLOW_FRACTION)
    slow_ranks = rng.choice(R, size=n_slow, replace=False)
    data[slow_ranks] *= SLOWDOWN
    counts = np.full((R, S), W, dtype=np.int32)
    truth = np.zeros(R, dtype=bool)
    truth[slow_ranks] = True
    return data, counts, truth


def f1(pred_mask, truth):
    tp = int((pred_mask & truth).sum())
    fp = int((pred_mask & ~truth).sum())
    fn = int((~pred_mask & truth).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def edge_case(w, seed):
    """Rounded normals (negative values, many ties), all-equal rows, and counts
    covering 0, 1, partial and full windows."""
    rng = np.random.default_rng(seed)
    data = np.round(rng.standard_normal((EDGE_RANKS, EDGE_SIGNALS, w)), 1).astype(np.float32)
    data[1] = 3.0
    data[4] = -2.5
    counts = rng.integers(0, w + 1, size=(EDGE_RANKS, EDGE_SIGNALS)).astype(np.int32)
    counts[0] = 0
    counts[2] = 1
    counts[3] = w
    return data, counts


class Smoke:
    def __init__(self, torch, card: str):
        self.torch = torch
        self.card = card

    def emit(self, phase: str, **fields) -> None:
        print(json.dumps({"phase": phase, "card": self.card, **fields}), flush=True)

    # -- timing ------------------------------------------------------------

    def time_each(self, fn, reps: int, flush) -> float:
        """Median ms of ``reps`` calls, each timed with its own CUDA events after
        the L2 cache was flushed (a report finds the ring cold)."""
        torch = self.torch
        for _ in range(3):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        for a, b in zip(starts, ends):
            flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))

    def time_loop(self, fn, reps: int) -> float:
        """Mean ms per call over ``reps`` back-to-back calls between two events."""
        torch = self.torch
        for i in range(3):
            fn(i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(reps):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    # -- checks ------------------------------------------------------------

    def compare(self, label, data, counts) -> float:
        """Kernel vs plain version on the same card tensors; returns the largest
        absolute weight error. Medians must be equal bit for bit."""
        from tpu_resiliency_torch.ops.scoring_kernels import (
            fused_median_weights,
            median_weights_reference,
        )
        from tpu_resiliency_torch.telemetry.scoring import masked_total

        torch = self.torch
        med_k, wt_k = fused_median_weights(data, counts)
        med_p, wt_p = median_weights_reference(data, counts)
        torch.cuda.synchronize()
        abs_sum = masked_total(data.abs(), counts)
        err = (wt_k - wt_p).abs()
        if not torch.equal(med_k, med_p):
            bad = int((med_k != med_p).sum())
            raise AssertionError(f"{label}: {bad} medians differ from the plain version")
        if not bool((err <= WEIGHT_RTOL * abs_sum).all()):
            raise AssertionError(f"{label}: weights off by up to {float(err.max())}")
        return float(err.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import tpu_resiliency_torch

    here = Path(__file__).resolve().parent
    if Path(tpu_resiliency_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: the port package does not lie beside this script", file=sys.stderr)
        return 1

    from tpu_resiliency_torch.ops import _build
    from tpu_resiliency_torch.ops.scoring_kernels import (
        KERNEL_NAME,
        block_threads,
        fused_median_weights,
        median_weights_reference,
    )
    from tpu_resiliency_torch.platform.device import card_name_and_power_limit
    from tpu_resiliency_torch.telemetry.scoring import masked_median, masked_total
    from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

    dev = torch.device("cuda")
    card = card_name_and_power_limit()
    smoke = Smoke(torch, card)
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smoke.emit("device", kind=kind, count=count, torch=torch.__version__,
               cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build([KERNEL_NAME])
    built = _build.load(KERNEL_NAME)
    threads = block_threads(W)
    smoke.emit("build", kernel=KERNEL_NAME, build_seconds=built.build_seconds,
               wall_seconds=time.perf_counter() - t0, ptxas=list(built.ptxas),
               threads_per_block=threads, dynamic_shared_bytes_per_block=threads * W * 4)

    # 3. kernel vs plain ------------------------------------------------------
    data_np, _, truth = make_telemetry(seed=0)
    rng = np.random.default_rng(1)
    rand_counts = torch.tensor(
        rng.integers(0, W + 1, size=(R, S)).astype(np.int32), device=dev
    )
    ring = torch.tensor(np.ascontiguousarray(data_np.transpose(2, 0, 1)), device=dev)
    ring_view = ring.permute(1, 2, 0)  # what MeshTelemetry.score hands the kernel
    checks = {
        "config4_ring_view": smoke.compare("config4 ring view", ring_view, rand_counts),
        "config4_contiguous": smoke.compare(
            "config4 contiguous", ring_view.contiguous(), rand_counts
        ),
    }
    for i, w in enumerate(EDGE_WINDOWS):
        d, c = edge_case(w, seed=10 + i)
        checks[f"edge_w{w}"] = smoke.compare(
            f"edge W={w}", torch.tensor(d, device=dev), torch.tensor(c, device=dev)
        )
    max_abs_err = max(checks.values())
    smoke.emit("kernel_vs_plain", medians_equal=True, weight_rtol_of_abs_sum=WEIGHT_RTOL,
               max_abs_weight_err=checks)

    # 4. main path ------------------------------------------------------------
    names = tuple(f"sig{s}" for s in range(S))
    rows = ring  # [W, R, S]: row i is step i's [R, S] timings, already on the card

    def drive(mt, rows):
        state = mt.init_state()
        for i in range(W):
            mt.push(state, rows[i])
        state, sc1 = mt.score(state)
        rep1 = mt.materialize(sc1)
        for i in range(W + 5):  # more than W pushes: the ring wraps
            mt.push(state, rows[i % W])
        state, sc2 = mt.score(state)
        rep2 = mt.materialize(sc2)
        return state, (sc1, sc2), (rep1, rep2)

    fused_median_weights.launches = 0
    mt = MeshTelemetry(R, signal_names=names, window=W)
    if not mt.use_kernel or mt.device.type != "cuda":
        raise AssertionError(f"main path is not on the kernel: {mt.device}, {mt.use_kernel}")
    state, scores, reports = drive(mt, rows)
    torch.cuda.synchronize()
    launches = fused_median_weights.launches
    if launches < 1:
        raise AssertionError("the main path launched the kernel no time")

    mt_sort = MeshTelemetry(R, signal_names=names, window=W, use_kernel=False)
    _, scores_sort, _ = drive(mt_sort, rows)
    mt_cpu = MeshTelemetry(R, signal_names=names, window=W, device="cpu")
    _, scores_cpu, _ = drive(mt_cpu, rows.cpu())

    perf_err = {}
    for label, other in (("sort_on_card", scores_sort), ("plain_on_cpu", scores_cpu)):
        for k in range(2):
            a, b = scores[k], other[k]
            if not torch.equal(a.straggler.cpu(), b.straggler.cpu()):
                raise AssertionError(f"report {k + 1}: straggler mask differs from {label}")
            diff = (a.perf.cpu() - b.perf.cpu()).abs()
            if not bool((diff <= 1e-5 * b.perf.cpu().abs()).all()):
                raise AssertionError(f"report {k + 1}: perf differs from {label} by {diff.max()}")
            perf_err[f"{label}_report{k + 1}"] = float(diff.max())

    rep1, rep2 = reports
    pred = np.zeros(R, dtype=bool)
    pred[[sid.rank for sid in rep1.identify_stragglers().by_perf]] = True
    f1_1 = f1(pred, truth)
    perf1 = np.array([rep1.perf_scores[r] for r in range(R)])
    ewma1 = np.array([rep1.ewma_scores[r] for r in range(R)])
    ewma2 = np.array([rep2.ewma_scores[r] for r in range(R)])
    if not (np.isfinite(perf1).all() and rep1.global_section_scores.shape == (R, S)):
        raise AssertionError("report 1 has non-finite perf scores or a wrong shape")
    if rep2.iteration != 2 or int(state.counts.sum()) != 0:
        raise AssertionError("the second report did not carry the iteration or reset the ring")
    if not (ewma2[truth] < ewma1[truth]).all():
        raise AssertionError("the EWMA of slow ranks did not fall across reports")
    if not torch.isfinite(state.hist_min).all():
        raise AssertionError("the historical minimum is not finite after two reports")
    if f1_1 < 0.9:
        raise AssertionError(f"F1 {f1_1} against the seeded truth is below 0.9")
    smoke.emit("main_path", ranks=R, signals=S, window=W, launches=launches,
               f1=f1_1, flagged=int(pred.sum()), truth=int(truth.sum()),
               perf_max_abs_diff=perf_err, ewma_slow_mean=[float(ewma1[truth].mean()),
                                                          float(ewma2[truth].mean())])

    # 5. times ----------------------------------------------------------------
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    mt_t = MeshTelemetry(R, signal_names=names, window=W)
    st = mt_t.init_state()
    for i in range(W):
        mt_t.push(st, rows[i])
    full_view = st.data.permute(1, 2, 0)
    full_counts = st.counts.clone()
    push_ms = smoke.time_loop(lambda i: mt_t.push(st, rows[i % W]), reps=500)
    st.counts.copy_(full_counts)
    score_ms = smoke.time_each(lambda: mt_t.score(st), reps=30, flush=flush)
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        mt_t.generate_report(st)
        wall.append((time.perf_counter() - t0) * 1e3)
    kernel_ms = smoke.time_each(lambda: fused_median_weights(full_view, full_counts),
                                reps=50, flush=flush)
    plain_ms = smoke.time_each(lambda: median_weights_reference(full_view, full_counts),
                               reps=10, flush=flush)
    sort_ms = smoke.time_each(
        lambda: (masked_median(full_view, full_counts), masked_total(full_view, full_counts)),
        reps=20, flush=flush,
    )
    valid = torch.arange(W, device=dev) < full_counts[..., None]
    x_nan = torch.where(valid, full_view, float("nan")).contiguous()
    library_ms = smoke.time_each(
        lambda: (torch.nanquantile(x_nan, 0.5, dim=-1, interpolation="midpoint"),
                 torch.nansum(x_nan, dim=-1)),
        reps=20, flush=flush,
    )
    bytes_moved = (full_view.numel() + full_counts.numel() + 2 * R * S) * 4
    pair_compares = R * S * W * W
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = pair_compares / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    smoke.emit(
        "times", ranks=R, signals=S, window=W, push_ms_per_step=push_ms,
        score_ms_per_report=score_ms, report_wall_ms_median=statistics.median(wall),
        amortised_ms_per_step=push_ms + score_ms / REPORT_INTERVAL,
        report_interval=REPORT_INTERVAL, kernel_ms=kernel_ms, plain_ms=plain_ms,
        sort_ms=sort_ms, nanquantile_ms=library_ms, bytes=bytes_moved,
        pair_compares=pair_compares, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
        bound_ms=bound_ms, bound_by=bound_by,
    )

    # 6. breakdown ------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            mt_t.score(st)
        torch.cuda.synchronize()
    rows_by_time = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0)
        if dev_us and evt.key and not evt.key.startswith("aten::"):
            rows_by_time.append((evt.key, dev_us / 5 / 1e3, evt.count // 5))
    rows_by_time.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows_by_time)
    smoke.emit(
        "breakdown", reports=5, device_busy_ms_per_report=busy_ms or "not measured",
        # share of the event-timed report (phase 5) in which the card ran no kernel
        idle_share=1.0 - busy_ms / score_ms if busy_ms else "not measured",
        device_ms_per_report_by_kernel=[
            {"kernel": k[:80], "ms": ms, "launches": n} for k, ms, n in rows_by_time[:12]
        ] or "not measured",
    )

    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max_abs_err, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        verdict="medians equal bit for bit; weights within 1e-5 of the window's sum of |x|",
        card=card,
    )]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
