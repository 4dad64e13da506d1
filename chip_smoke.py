#!/usr/bin/env python3
"""Drive the PyTorch port's straggler-telemetry paths on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA card
and the CUDA toolkit (``nvcc``), builds the port's three window-reduction kernels
(``loop``, ``pairwise``, ``radix``) from the checkout's sources, all ``nvcc`` runs
started together, and runs these phases, each printing one JSON line that carries
the card's name and power limit:

1. ``device``: the card, its count, and ``nvidia-smi``'s name and power limit.
2. ``build``: each kernel's build seconds and ptxas register / shared-memory / spill
   lines; the loop kernel's registers, stack frame and spills per instance of its
   register network (P = 1 .. 64) and of its general path, and the same for the
   pairwise kernel's register instances (P = 1 .. 64) and its tiled path, each with
   its SASS instruction count (``cuobjdump``; each register instance is one unrolled
   run, so that is its instructions per thread). A register instance of either kernel
   with P <= 32 that spills or keeps a stack frame fails the run.
3. ``kernel_vs_plain``: every kernel against its own plain PyTorch version on the
   card. ``loop`` at config 4 (4096 ranks x 64 signals x window 32; the ring's
   permuted view and a contiguous copy, random counts in [0, W]) and at edge windows
   W in {1, 2, 7, 31, 32, 33, 63, 64, 65, 128, 256} (each size of its register
   network and the switch to its general path past 64); ``pairwise`` at config 4 and
   at W in {1, 2, 7, 31, 32, 33, 63, 64, 65} (each size of its register path and the
   switch to its tiled path past 64); ``radix`` at the long window's full size
   (4096 x 64 x 512), on the view and a copy; ``pairwise`` and ``radix`` at edge
   windows W in {1, 7, 32, 129, 256, 512, 1024}. Edge windows hold ties, all-equal
   windows, negative values, -0.0 and counts 0 and 1.
   ``radix_adversarial`` windows (ties, one value, signed zeros, keys that differ only
   in their lowest bits, one outlier, telemetry around 1.0, counts 0, 1, W and past W)
   meet ``radix`` at W in {1, 7, 33, 129, 512} and the tile's largest window (1758),
   and ``loop`` at W in {1, 7, 32, 33, 64, 65}, passed to
   ``fused_median_weights`` directly; ``pairwise`` meets them at its nine windows
   with +-inf added (``with_infinities``). Medians must be equal bit for
   bit, compared as int32 (the modes differ in the sign of a zero median, so each
   kernel is held to its own plain version); across modes they must be equal by
   value. Weights must lie within ``weight_rtol(W)`` of the window's sum of |x|, and
   be equal where they are not finite.
4. ``main_path``: ``MeshTelemetry`` at config 4 on the card, fed the seeded telemetry
   of ``bench.py`` (5% slow ranks at 1.6x): W pushes, a report, W + 5 more pushes
   (the ring wraps), a second report. The auto-selected kernel's launch count must
   rise; the straggler mask must equal the sort path's on the card and the plain
   path's on the CPU; F1 against the seeded truth is printed.
5. ``long_window_path``: ``MeshTelemetry`` at 4096 x 64 x window 512 (a 512 MiB ring)
   on the card, fed the same generator's telemetry at W = 512: 512 pushes and a
   report, then 300 pushes and a report over windows filled 300 of 512. The kernel
   mode must be ``radix`` and its launch count must rise; both straggler masks must
   equal the sort path's on the card; F1 against the seeded truth must reach 0.99.
   The same run at 256 ranks must match the CPU's plain path (the plain radix is
   slow on the host at full width).
6. ``explicit_mode_path``: the modes that auto-selection ran on neither path above
   (``pairwise`` always), at config 4 as a caller who asks for one reaches it:
   ``fused_median_weights(..., mode=...)`` on the ring, then
   ``ReportGenerator.generate_summary_report``. Its launch count must rise and its
   mask equal the main path's first report's.
7. ``times``, at config 4 and at W = 512, after a warm-up. Push per step and score
   per report are CUDA-event times (what users pay, the host's enqueue included).
   The kernels, their plain versions, the sort-based masked median + total,
   ``torch.nanquantile`` + ``torch.nansum`` as the library yardstick (never called
   by the port) and the radix kernel on windows of one value each, where no digit
   round runs (its staging, register load, weight and hi pass alone), are device
   times (``kernel_sweep.device_ms``: the profiler's kernel durations per call), with
   the L2 flushed before each call; each also gives its CUDA-event time as
   ``events_ms``; every event time is taken before the process's first profiler
   session. Then the radix kernel's digit rounds on the long window's data
   (``digit_work``), which also give its operation count for the bound, and the
   compare rate the operation bounds are priced at, with its source.
8. ``sweep``: ``tpu_resiliency_torch.ops.kernel_sweep`` over W in {32 .. 1024} x
   R in {256, 1024, 4096} (S = 64): each kernel and the sort path, and the loop cap
   and radix verdict it derives, beside the defaults the package carries.
9. ``breakdown``: ``torch.profiler`` device time by kernel over a few reports at
   config 4 and at W = 512.
10. ``detector_path``: the straggler-detection API on the card.
   ``integrations.run_training`` drives 400 steps of config 4's workload: each step
   pushes one [4096, 64] row into ``MeshTelemetry(4096, window 32, 64 signals)``
   inside a ``record_function("push")`` region, every 100th step (i % 100 == 0,
   all profiled) then scores a report inside ``record_function("report")``, and
   the step ends with a synchronize (a train step's loss read). ``StragglerDetectionCallback(
   profile_programs_every=50, profile_ops=True)`` with the Detector's default
   window (128) and 64 signals times the steps, and its ``report_time_interval``
   is 100 steps of the workload without the callback, so several reports fire.
   Every Detector report must hold ``sec/train_step``, ``prog/push``,
   ``prog/report`` and the ``loop`` kernel's ``op/`` signal; the ``op/`` samples
   of the ``loop`` kernel must number its launches in profiled steps (the
   per-mode counter); every ``prog/`` and ``op/`` sample must be positive and no
   longer than its step; every config-4 report but the first (one row in the
   ring) must flag the main path's ranks.
   It prints, on CUDA events, ms per step with the callback and without it, the
   median step by kind (plain, profiled, Detector report round) and the device
   span of each region.
11. ``group_path``: config 4's summaries (the sort path's medians and totals of the
   ring) scored through a one-process NCCL group on the card:
   ``MeshTelemetry(group=...)``, ``score_local_summary`` and ``report_from_summary``
   over two rounds. The masks must equal, and the scores match within
   ``GROUP_TOL``, the single-program ``score_summary`` on the same tensors. The
   collectives run on CUDA tensors; several ranks are rehearsed on the CPU with
   gloo (``tests/test_torch_group_scoring.py``).

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero; without a
CUDA card, or without the rest of the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

R, S, W = 4096, 64, 32  # config 4
LONG_W = 512  # the long-window path
LONG_PARTIAL = 300  # pushes before its second report
CPU_RANKS = 256  # ranks of the CPU comparison of the long-window run
SLOW_FRACTION = 0.05
SLOWDOWN = 1.6
EDGE_WINDOWS = (1, 2, 7, 31, 32, 33, 63, 64, 65, 128, 256)
MODE_EDGE_WINDOWS = (1, 7, 32, 129, 256, 512, 1024)
RADIX_ADVERSARIAL_WINDOWS = (1, 7, 33, 129, 512)  # and the tile's largest window
LOOP_ADVERSARIAL_WINDOWS = (1, 7, 32, 33, 64, 65)
PAIRWISE_WINDOWS = (1, 2, 7, 31, 32, 33, 63, 64, 65)  # edge and adversarial
EDGE_RANKS = EDGE_SIGNALS = 64
REPORT_INTERVAL = 100  # steps per report for the amortised per-step cost
DETECTOR_STEPS = 400
PROFILE_EVERY = 50  # the callback's profiled steps: i % 50 == 0
# The kernels of csrc/median_weights.cu: the register network (W <= 64) and the
# general path; ``loop`` launches one of them per report.
LOOP_KERNEL_FUNCTIONS = ("median_weights_network_kernel", "median_weights_loop_kernel")
# Score tolerances of the CPU tests of the group mode (tests/test_torch_scoring.py TOL).
GROUP_TOL = {
    "section_scores": dict(rtol=1e-6, atol=0.0),
    "individual_section_scores": dict(rtol=1e-6, atol=0.0),
    "perf": dict(rtol=1e-5, atol=0.0),
    "ewma": dict(rtol=1e-5, atol=0.0),
    "z": dict(rtol=1e-4, atol=1e-4),
    "historical_min": dict(rtol=0.0, atol=0.0),
}
# The kernels' bounds. Bytes at the H100 SXM's published memory rate (NVIDIA data
# sheet). Operations: every kernel's work is compares, minima and maxima, or 32-bit
# integer adds and logic (radix keys), which issue at 64 results per clock per SM on
# sm_90 (CUDA C++ Programming Guide, throughput of native arithmetic instructions);
# the rate is that times the card's SM count and its largest SM clock.
HBM_BYTES_PER_S = 3.35e12
COMPARES_PER_CLOCK_PER_SM = 64
L2_FLUSH_BYTES = 64 << 20  # larger than the 50 MB L2


def weight_rtol(w: int) -> float:
    """Weight tolerance, as a share of the window's sum of |x|. Kernel and plain
    version sum the same W terms in other orders. Up to W = 256 that stays within
    1e-5 (the tolerance config 4's and the edge windows' runs were argued and measured
    at); past it the reordering error of two f32 sums of W terms grows to about
    W * 2^-24 of the sum (3.1e-5 at W = 512, 6.1e-5 at W = 1024)."""
    return 1e-5 if w <= 256 else w * 2.0**-24


KERNELS = {
    "loop": {
        "name": "median_weights_loop",
        "route": "cuda",
        "source": "tpu_resiliency_torch/csrc/median_weights.cu",
        "replaces": "tpu_resiliency/ops/scoring_pallas.py:42",
    },
    "pairwise": {
        "name": "median_weights_pairwise",
        "route": "cuda",
        "source": "tpu_resiliency_torch/csrc/median_weights_pairwise.cu",
        "replaces": "tpu_resiliency/ops/scoring_pallas.py:84",
    },
    "radix": {
        "name": "median_weights_radix",
        "route": "cuda",
        "source": "tpu_resiliency_torch/csrc/median_weights_radix.cu",
        "replaces": "tpu_resiliency/ops/scoring_pallas.py:139",
    },
}


def make_telemetry(seed=0, w=W, ranks=R):
    """``bench.py``'s seeded config-4 telemetry at window ``w``: windows [ranks, S, w],
    full counts, and the truth mask of the slow ranks."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.8, 1.2, size=(1, S, 1)).astype(np.float32)
    data = base * (1.0 + 0.05 * rng.standard_normal((ranks, S, w)).astype(np.float32))
    n_slow = int(ranks * SLOW_FRACTION)
    slow_ranks = rng.choice(ranks, size=n_slow, replace=False)
    data[slow_ranks] *= SLOWDOWN
    counts = np.full((ranks, S), w, dtype=np.int32)
    truth = np.zeros(ranks, dtype=bool)
    truth[slow_ranks] = True
    return data, counts, truth


def radix_adversarial(w, seed, ranks=64, signals=64):
    """Windows ``[ranks, signals, w]`` where a digit-round radix select could go wrong.
    Rank r % 8 picks the values: 0 rounded normals (ties, negatives, -0.0); 1 one value
    per window; 2 mixed -0.0 and +0.0 with a few +-1; 3 and 7 keys that differ only in
    their lowest 1-3 bits (positive and negative bases); 4 one outlier in an otherwise
    equal window; 5 telemetry around a base (5% noise, crossing 1.0 for some bases);
    6 negatives only. Signal s % 8 picks the count: 0, 1, W, W + 1, 2W + 1 (both order
    statistics past the valid slots), 2W (the upper one past them), or random in
    [0, W]."""
    rng = np.random.default_rng(seed)
    shape = (ranks, signals, w)
    family = np.arange(ranks)[:, None, None] % 8
    normals = np.round(rng.standard_normal(shape), 1).astype(np.float32)
    per_window = np.round(rng.standard_normal((ranks, signals, 1)), 1).astype(np.float32)
    zeros = rng.choice(np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0], np.float32), size=shape)
    nbits = 1 + np.arange(signals)[None, :, None] % 3
    low = rng.integers(0, 1 << 3, size=shape) % (1 << nbits)
    base_bits = (np.abs(per_window) + np.float32(0.5)).view(np.int32)  # in [0.5, 6)
    low_pos = (base_bits + low).astype(np.int32).view(np.float32)
    low_neg = (base_bits | np.int32(-(2**31))) + low
    low_neg = low_neg.astype(np.int32).view(np.float32)
    outlier = np.broadcast_to(per_window, shape).copy()
    at = rng.integers(0, w, size=(ranks, signals))
    big = rng.choice(np.array([1e3, -1e3, 1e-3, 3.0e38], np.float32), size=(ranks, signals))
    np.put_along_axis(outlier, at[..., None], big[..., None], axis=-1)
    around = rng.uniform(0.8, 1.2, (ranks, signals, 1)).astype(np.float32)
    around = around * (1.0 + 0.05 * rng.standard_normal(shape).astype(np.float32))
    negatives = -np.abs(normals) * 10.0
    choices = (normals, np.broadcast_to(per_window, shape), zeros, low_pos, outlier,
               around, negatives, low_neg)
    data = np.choose(family, choices).astype(np.float32)
    counts = rng.integers(0, w + 1, size=(ranks, signals))
    pattern = (0, 1, w, w + 1, 2 * w + 1, 2 * w)
    for s, c in enumerate(pattern):
        counts[:, s::8] = c
    return data, counts.astype(np.int32)


def with_infinities(data, seed):
    """``data`` with +inf in about 30% of the slots of ranks r % 8 == 0 and -inf in
    as many of ranks r % 8 == 6: valid infinities that tie with the +inf padding."""
    rng = np.random.default_rng(seed)
    out = data.copy()
    hit = rng.random(out.shape) < 0.3
    fam = np.arange(out.shape[0]) % 8
    out[(fam == 0)[:, None, None] & hit] = np.inf
    out[(fam == 6)[:, None, None] & hit] = -np.inf
    return out


def compare_rate(torch):
    """``(compares per second, source)``: the card's SM count x 64 per clock x its
    largest SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    mhz = float(out.stdout.split()[0])
    rate = sms * COMPARES_PER_CLOCK_PER_SM * mhz * 1e6
    return rate, (f"{sms} SMs x {COMPARES_PER_CLOCK_PER_SM} compares per clock per SM x "
                  f"{mhz:.0f} MHz (nvidia-smi clocks.max.sm)")


def sass_instructions(lib_path, nvcc):
    """Instructions (NOPs left out) per kernel function of a built library, by
    mangled name, from ``cuobjdump -sass`` beside ``nvcc``."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, current = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current and re.search(r"/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
            counts[current] += 1
    return counts


def register_instances(by_kernel, pattern, sass):
    """``({P: info}, other)`` of a kernel library's ptxas lines grouped by kernel
    (``_build.ptxas_by_kernel``): each instance whose mangled name matches
    ``pattern`` (its template argument P in the first group) with its registers,
    stack frame, spills and SASS instructions, and the info of the one other kernel
    (the general or tiled path)."""
    instances, other = {}, None
    for name, info in by_kernel.items():
        info = dict(info, sass_instructions=sass.get(name))
        m = re.search(pattern, name)
        if m:
            instances[int(m.group(1))] = info
        else:
            other = info
    return instances, other


def bitonic_comparators(p):
    """Compare-exchanges of the loop kernel's bitonic network over ``p`` slots (a
    power of two): p/2 per sub-stage, log2(p) (log2(p) + 1) / 2 sub-stages."""
    log = p.bit_length() - 1
    return p // 2 * log * (log + 1) // 2


def pairwise_compares(w, register_max_window):
    """Compares the pairwise kernel makes per window of ``w`` slots: on its register
    path (W up to ``register_max_window``) one per pair of the P slots it holds, P the
    smallest power of two >= W; past it, on the tiled path, W^2, every ordered pair."""
    if w <= register_max_window:
        p = 1 << max(w - 1, 0).bit_length()
        return p * (p - 1) // 2
    return w * w


def digit_work(data, counts, chunk=1 << 15):
    """What the radix kernel's selection of the lower median does on these windows:
    ``(rounds, examined)`` per window, flattened, as int64 tensors on the data's device.
    ``examined`` sums the candidates of every digit round (all valid keys in the first).
    Vectorised over windows: per round the candidates' least and largest key give the
    top differing bit, a 5-bit digit below it, the bin of rank k, and its keys."""
    import torch

    w = data.shape[-1]
    x = data.reshape(-1, w)
    cnt = counts.reshape(-1).to(torch.int64)
    rounds = torch.zeros_like(cnt)
    examined = torch.zeros_like(cnt)
    pos = torch.arange(w, device=data.device)
    for a in range(0, x.shape[0], chunk):
        b = x[a:a + chunk].contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        u = torch.where(b >= 1 << 31, b ^ 0xFFFFFFFF, b | 1 << 31)  # the order key
        n_valid = cnt[a:a + chunk].clamp(0, w)
        k = (cnt[a:a + chunk].clamp(min=1) - 1) // 2
        cand = pos < n_valid[:, None]
        active = k < n_valid
        while True:
            big = torch.where(cand, u, -1).amax(1)
            small = torch.where(cand, u, 1 << 32).amin(1)
            live = active & (big != small)
            if not bool(live.any()):
                break
            _, e = torch.frexp((big ^ small).clamp(min=1).double())
            shift = (e.to(torch.int64) - 1 - 4).clamp(min=0)
            digit = (u >> shift[:, None]) & 31
            bins = torch.zeros((u.shape[0], 32), dtype=torch.int64, device=u.device)
            bins.scatter_add_(1, torch.where(cand, digit, 0), cand.to(torch.int64))
            incl = bins.cumsum(1)
            pick = (incl > k[:, None]).to(torch.int32).argmax(1, keepdim=True)
            k = torch.where(live, k - (incl - bins).gather(1, pick)[:, 0], k)
            examined[a:a + chunk] += torch.where(live, cand.sum(1), 0)
            rounds[a:a + chunk] += live.to(torch.int64)
            cand = cand & ~(live[:, None] & (digit != pick))
    return rounds, examined


def f1(pred_mask, truth):
    tp = int((pred_mask & truth).sum())
    fp = int((pred_mask & ~truth).sum())
    fn = int((~pred_mask & truth).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def edge_case(w, seed):
    """Rounded normals (negative values, -0.0, many ties), all-equal rows, and counts
    covering 0, 1, partial and full windows."""
    rng = np.random.default_rng(seed)
    data = np.round(rng.standard_normal((EDGE_RANKS, EDGE_SIGNALS, w)), 1).astype(np.float32)
    data[1] = 3.0
    data[4] = -2.5
    data[5] = -0.0
    counts = rng.integers(0, w + 1, size=(EDGE_RANKS, EDGE_SIGNALS)).astype(np.int32)
    counts[0] = 0
    counts[2] = 1
    counts[3] = w
    counts[5] = w
    return data, counts


def flagged(report, n_ranks):
    pred = np.zeros(n_ranks, dtype=bool)
    pred[[sid.rank for sid in report.identify_stragglers().by_perf]] = True
    return pred


class Smoke:
    def __init__(self, torch, card: str):
        self.torch = torch
        self.card = card

    def emit(self, phase: str, **fields) -> None:
        print(json.dumps({"phase": phase, "card": self.card, **fields}), flush=True)

    # -- timing ------------------------------------------------------------

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

    def compare(self, label, mode, data, counts):
        """Kernel of ``mode`` vs its plain version on the same card tensors. Medians
        must be equal bit for bit (as int32); weights within ``weight_rtol(W)`` of the
        window's sum of |x|, and equal where they are not finite (a window with
        infinities). Returns ``(largest absolute weight error, the kernel's
        medians)``."""
        from tpu_resiliency_torch.ops.scoring_kernels import PLAIN_VERSIONS, fused_median_weights
        from tpu_resiliency_torch.telemetry.scoring import masked_total

        torch = self.torch
        med_k, wt_k = fused_median_weights(data, counts, mode=mode)
        med_p, wt_p = PLAIN_VERSIONS[mode](data, counts)
        torch.cuda.synchronize()
        if not torch.equal(med_k.view(torch.int32), med_p.view(torch.int32)):
            bad = int((med_k.view(torch.int32) != med_p.view(torch.int32)).sum())
            raise AssertionError(f"{label} {mode}: {bad} medians differ from the plain version")
        abs_sum = masked_total(data.abs(), counts)
        finite = torch.isfinite(wt_p)
        same = (wt_k == wt_p) | (torch.isnan(wt_k) & torch.isnan(wt_p))
        if not bool(same[~finite].all()):
            raise AssertionError(f"{label} {mode}: non-finite weights differ")
        err = torch.where(finite, (wt_k - wt_p).abs(), 0.0)
        rtol = weight_rtol(data.shape[-1])
        if not bool((err <= rtol * abs_sum).all()):
            raise AssertionError(f"{label} {mode}: weights off by up to {float(err.max())}")
        return float(err.max()), med_k


def detector_path(smoke, rows, names, main_mask):
    """Phase 10: ``run_training`` with ``StragglerDetectionCallback`` over config 4's
    workload on the card. Returns the ``loop`` launches of the run."""
    import torch
    from torch.profiler import record_function

    from tpu_resiliency_torch.integrations import (
        Callback,
        LoopContext,
        StragglerDetectionCallback,
        run_training,
    )
    from tpu_resiliency_torch.ops import scoring_kernels as sk
    from tpu_resiliency_torch.telemetry import Detector, MeshTelemetry

    class Recording(StragglerDetectionCallback):
        """Keeps each profiler window's samples by step, and each report."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.windows, self.reports = {}, []

        def _fold_profiler_window(self):
            programs, ops = super()._fold_profiler_window()
            self.windows[self._step_count - 1] = (programs, ops)
            return programs, ops

        def _handle_report(self, ctx, report):
            super()._handle_report(ctx, report)
            self.reports.append((ctx.step, report))

    class StepEvents(Callback):
        """A CUDA event per step at one hook: first in the list at
        ``on_step_start``, last at ``on_step_end``."""

        def __init__(self, hook):
            self.events = []
            setattr(self, hook, self._record)

        def _record(self, ctx):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

    def workload(log=None, cb=None):
        mt = MeshTelemetry(R, signal_names=names, window=W)
        reports = []

        def step(state, i):
            t0 = time.perf_counter()
            before = sk.fused_median_weights.launches_by_mode["loop"]
            profiled = cb is not None and cb._program_profiler is not None and cb._program_profiler.active
            with record_function("push"):
                mt.push(state, rows[i % W])
            if i % REPORT_INTERVAL == 0:
                with record_function("report"):
                    state, rep = mt.generate_report(state)
                reports.append(rep)
            torch.cuda.synchronize()  # the step's loss read
            if log is not None:
                log[i] = (profiled, sk.fused_median_weights.launches_by_mode["loop"] - before,
                          time.perf_counter() - t0)
            return state

        return mt, step, reports

    def timed_run(step, state, callbacks=()):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ctx = run_training(step, state, DETECTOR_STEPS, callbacks=callbacks,
                           ctx=LoopContext(rank=0, world_size=1))
        b.record()
        torch.cuda.synchronize()
        if ctx.step != DETECTOR_STEPS:
            raise AssertionError(f"the loop stopped at step {ctx.step}")
        return a.elapsed_time(b) / DETECTOR_STEPS

    log0 = {}
    mt0, step0, _ = workload(log0)
    timed_run(step0, mt0.init_state())  # warm-up
    ms_without = timed_run(step0, mt0.init_state())
    # 100 median steps of the workload: the Detector's tracker measures steps with
    # the callback, which are longer, so its interval comes out below 100 steps.
    report_time_interval = REPORT_INTERVAL * statistics.median(t for _, _, t in log0.values())

    log = {}
    cb = Recording(report_time_interval=report_time_interval,
                   profile_programs_every=PROFILE_EVERY, profile_ops=True)
    starts, ends = StepEvents("on_step_start"), StepEvents("on_step_end")
    mt, step, c4_reports = workload(log, cb)
    sk.reset_launches()
    ms_with = timed_run(step, mt.init_state(), callbacks=[starts, cb, ends])
    launches = dict(sk.fused_median_weights.launches_by_mode)
    if Detector.initialized:
        raise AssertionError("the Detector outlived the loop")

    profiled_steps = sorted(cb.windows)
    if profiled_steps != list(range(0, DETECTOR_STEPS, PROFILE_EVERY)):
        raise AssertionError(f"profiler windows at steps {profiled_steps}")
    if len(cb.reports) < 2:
        raise AssertionError(f"{len(cb.reports)} Detector reports fired, want 2 or more")
    loop_ops = {f"op/{k}" for k in LOOP_KERNEL_FUNCTIONS}
    for at, rep in cb.reports:
        names_ = set(rep.section_names)
        missing = {"sec/train_step", "prog/push", "prog/report"} - names_
        if missing or not loop_ops & names_:
            raise AssertionError(f"the report at step {at} lacks {sorted(missing)} or the "
                                 f"loop kernel's op/ signal: {sorted(names_)}")
    loop_samples = sum(len(ops.get(k, ())) for _, ops in cb.windows.values()
                       for k in LOOP_KERNEL_FUNCTIONS)
    loop_in_profiled = sum(n for profiled, n, _ in log.values() if profiled)
    if loop_samples != loop_in_profiled or loop_samples == 0:
        raise AssertionError(f"{loop_samples} op/ samples of the loop kernel against "
                             f"{loop_in_profiled} launches in profiled steps")
    for i, (programs, ops) in cb.windows.items():
        step_s = log[i][2]
        for name, secs in (*programs.items(), *ops.items()):
            if not all(0.0 < x <= step_s for x in secs):
                raise AssertionError(f"step {i}: a sample of {name} lies outside "
                                     f"(0, {step_s}] s: {secs}")
    for k, rep in enumerate(c4_reports[1:], start=1):  # the first scores one row
        if not np.array_equal(flagged(rep, R), main_mask):
            raise AssertionError(f"config-4 report {k + 1} of the loop flags other ranks")

    spans = [a.elapsed_time(b) for a, b in zip(starts.events, ends.events)]
    det_steps = {at for at, _ in cb.reports}
    c4_steps = set(range(0, DETECTOR_STEPS, REPORT_INTERVAL))
    busy = set(cb.windows) | det_steps | c4_steps

    def median_of(steps):
        steps = sorted(steps)
        return {"ms": statistics.median(spans[i] for i in steps), "steps": len(steps)} if steps \
            else "not measured"

    region_ms = {}
    for programs, ops in cb.windows.values():
        for name, secs in programs.items():
            region_ms.setdefault(name, []).extend(x * 1e3 for x in secs)
    loop_ms = [x * 1e3 for _, ops in cb.windows.values() for k in LOOP_KERNEL_FUNCTIONS
               for x in ops.get(k, ())]
    smoke.emit(
        "detector_path", ranks=R, signals=S, window=W, steps=DETECTOR_STEPS,
        profile_every=PROFILE_EVERY, detector_window=Detector.window,
        detector_signals=Detector.max_signals,
        report_time_interval_s=report_time_interval,
        detector_reports=[at for at, _ in cb.reports],
        report_signals=len(cb.reports[-1][1].section_names),
        launches=launches, loop_op_samples=loop_samples, loop_launches_in_profiled_steps=loop_in_profiled,
        ms_per_step_without_callback=ms_without, ms_per_step_with_callback=ms_with,
        step_ms_median={
            "plain": median_of(set(range(DETECTOR_STEPS)) - busy),
            "profiled": median_of(set(cb.windows) - det_steps - c4_steps),
            "detector_report_round": median_of(det_steps - set(cb.windows) - c4_steps),
            "config4_report_profiled": median_of(c4_steps - det_steps),
        },
        device_region_ms_median={k: statistics.median(v) for k, v in region_ms.items()},
        loop_kernel_device_ms_median=statistics.median(loop_ms),
        op_samples_by_window={i: sum(map(len, ops.values())) for i, (_, ops) in
                              sorted(cb.windows.items())},
        config4_reports=len(c4_reports),
    )
    return launches["loop"]


def group_path(smoke, view, counts, names):
    """Phase 11: config 4's summaries through a one-process NCCL group on the card,
    against the single-program scoring on the same tensors."""
    import socket

    import torch
    import torch.distributed as dist

    from tpu_resiliency_torch.telemetry import MeshTelemetry, scoring
    from tpu_resiliency_torch.telemetry.reporting import build_report

    diffs = {}

    def close(label, name, got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        tol = GROUP_TOL[name]
        finite = np.isfinite(want)
        if not (np.array_equal(np.isfinite(got), finite)
                and np.array_equal(got[~finite], want[~finite])):
            raise AssertionError(f"{label}: {name} differs off the finite values")
        err = np.abs(got - want)[finite]
        if not (err <= tol["atol"] + tol["rtol"] * np.abs(want[finite])).all():
            raise AssertionError(f"{label}: {name} off by up to {err.max()}")
        diffs[f"{label}_{name}"] = float(err.max()) if err.size else 0.0

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        mt = MeshTelemetry(R, signal_names=names, window=W, group=group)
        if mt.device.type != "cuda" or dist.get_backend(group) != "nccl":
            raise AssertionError(f"the group path runs on {mt.device} over {dist.get_backend(group)}")
        medians = scoring.masked_median(view, counts)
        weights = scoring.masked_total(view, counts)
        ewma = torch.ones(R, device=view.device)
        hist = torch.full((R, S), float("inf"), device=view.device)
        flagged_ranks = []
        for k in range(2):
            label = f"round{k + 1}"
            med_k = medians * (1.0 + 0.25 * k)  # the second round runs slower everywhere
            ref = scoring.score_summary(med_k, weights, counts, ewma, hist)
            ewma, hist = ref.ewma, ref.historical_min
            ref_host = scoring.scores_to_host(ref)
            if k == 0:  # score_local_summary, its rows gathered, against every field
                local = mt.score_local_summary(med_k, weights, counts)
                got = scoring.scores_to_host(scoring.gather_scores(local, group))
                if not np.array_equal(got.straggler, ref_host.straggler):
                    raise AssertionError(f"{label}: the group mask differs")
                for name in GROUP_TOL:
                    close(label, name, getattr(got, name), getattr(ref_host, name))
                report = mt.materialize(local)
            else:  # report_from_summary, against the single-program report
                report = mt.report_from_summary(med_k, weights, counts)
            want = build_report(ref_host, rank=0, world_size=R, iteration=k + 1,
                                section_names=names, rank_to_host=None)
            if not np.array_equal(flagged(report, R), flagged(want, R)):
                raise AssertionError(f"{label}: the group report flags other ranks")
            for field, name in (("perf_scores", "perf"), ("z_scores", "z"),
                                ("ewma_scores", "ewma")):
                close(f"{label}_report", name, list(getattr(report, field).values()),
                      list(getattr(want, field).values()))
            close(f"{label}_report", "section_scores", report.global_section_scores,
                  want.global_section_scores)
            flagged_ranks.append(int(flagged(report, R).sum()))
    finally:
        dist.destroy_process_group()
    smoke.emit("group_path", ranks=R, signals=S, backend="nccl", group_size=1,
               rounds=2, flagged=flagged_ranks, max_abs_diff=diffs, tolerance=GROUP_TOL)


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

    from tpu_resiliency_torch.ops import _build, kernel_sweep
    from tpu_resiliency_torch.ops import scoring_kernels as sk
    from tpu_resiliency_torch.platform.device import card_name_and_power_limit
    from tpu_resiliency_torch.telemetry.reporting import ReportGenerator
    from tpu_resiliency_torch.telemetry.scoring import masked_median, masked_total
    from tpu_resiliency_torch.telemetry.sharded import MeshTelemetry

    fused_median_weights = sk.fused_median_weights
    # Median ms of reps calls, each between its own CUDA events after the L2 cache
    # was flushed (a report finds the ring cold): the host's enqueue included, as
    # users pay it. Kernel times are device times (kernel_sweep.device_ms).
    time_each = kernel_sweep.time_ms
    dev = torch.device("cuda")
    card = card_name_and_power_limit()
    smoke = Smoke(torch, card)
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smoke.emit("device", kind=kind, count=count, torch=torch.__version__,
               cuda=torch.version.cuda, python=sys.version.split()[0])
    t_start = time.perf_counter()

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(sk.KERNEL_NAMES.values())
    built = {mode: _build.load(name) for mode, name in sk.KERNEL_NAMES.items()}
    nvcc = _build.find_nvcc()

    def instances(mode, pattern, top, other_name):
        """Each register instance P = 1 .. top of a kernel and its other path; a
        missing instance, or one with P <= 32 that keeps local memory, fails."""
        lib = built[mode]
        regs, other = register_instances(_build.ptxas_by_kernel(lib.ptxas), pattern,
                                         sass_instructions(lib.lib._name, nvcc))
        want = [1 << i for i in range(top.bit_length())]
        if sorted(regs) != want or other is None:
            raise AssertionError(f"{mode} register instances P = {sorted(regs)}, want {want} "
                                 f"and the {other_name} path")
        for p, info in regs.items():
            local = sum(info.get(k, 0) for k in ("stack_frame", "spill_stores", "spill_loads"))
            if p <= 32 and local:
                raise AssertionError(f"{mode} register instance P = {p} keeps {local} bytes "
                                     f"in local memory: {info}")
        return {**{f"p{p}": regs[p] for p in want}, other_name: other}

    loop_instances = instances("loop", r"network_kernelILi(\d+)E", sk.NETWORK_MAX_WINDOW,
                               "general")
    pairwise_instances = instances("pairwise", r"registers_kernelILi(\d+)E",
                                   sk.PAIRWISE_REGISTER_MAX_WINDOW, "tiled")
    smoke.emit(
        "build", wall_seconds=time.perf_counter() - t0,
        kernels={mode: {"source": name, "build_seconds": b.build_seconds,
                        "ptxas": list(b.ptxas)}
                 for (mode, name), b in zip(sk.KERNEL_NAMES.items(), built.values())},
        loop_instances=loop_instances,
        pairwise_instances=pairwise_instances,
        loop_threads_per_block={w: sk.block_threads(w) for w in (W, LONG_W)},
        tile_dynamic_shared_bytes_per_block={w: w * (sk.TILE_WINDOWS + 1) * 4
                                             for w in (W, LONG_W, 1024)},
    )

    # 3. kernel vs plain -------------------------------------------------------
    data_np, _, truth = make_telemetry(seed=0)
    rng = np.random.default_rng(1)
    rand_counts = torch.tensor(
        rng.integers(0, W + 1, size=(R, S)).astype(np.int32), device=dev
    )
    ring = torch.tensor(np.ascontiguousarray(data_np.transpose(2, 0, 1)), device=dev)
    ring_view = ring.permute(1, 2, 0)  # what MeshTelemetry.score hands the kernel
    errs = {mode: {} for mode in sk.MODES}
    by_value = {}

    def check_modes(label, modes, data, counts):
        meds = {}
        for mode in modes:
            errs[mode][label], meds[mode] = smoke.compare(label, mode, data, counts)
        first = meds[modes[0]]
        for mode in modes[1:]:
            if not torch.equal(meds[mode], first):  # by value: -0.0 == +0.0
                raise AssertionError(f"{label}: {mode} medians differ in value from {modes[0]}")
        by_value[label] = list(modes)

    for label, d in (("config4_ring_view", ring_view), ("config4_contiguous", ring_view.contiguous())):
        check_modes(label, ("loop", "pairwise", "radix"), d, rand_counts)
    for i, w in enumerate(EDGE_WINDOWS):
        d, c = edge_case(w, seed=10 + i)
        check_modes(f"edge_w{w}", ("loop",), torch.tensor(d, device=dev), torch.tensor(c, device=dev))
    for i, w in enumerate(MODE_EDGE_WINDOWS):
        d, c = edge_case(w, seed=30 + i)
        modes = tuple(m for m in ("pairwise", "radix") if w <= sk.MODE_MAX_WINDOW[m])
        check_modes(f"edge_w{w}", modes + ("loop",) if w <= 256 else modes,
                    torch.tensor(d, device=dev), torch.tensor(c, device=dev))

    long_np, _, long_truth = make_telemetry(seed=0, w=LONG_W)
    long_ring = torch.tensor(np.ascontiguousarray(long_np.transpose(2, 0, 1)), device=dev)
    del long_np
    long_view = long_ring.permute(1, 2, 0)
    long_counts = torch.tensor(
        rng.integers(0, LONG_W + 1, size=(R, S)).astype(np.int32), device=dev
    )
    for label, d in (("long_ring_view", long_view), ("long_contiguous", long_view.contiguous())):
        errs["radix"][label], _ = smoke.compare(label, "radix", d, long_counts)
    for i, w in enumerate(RADIX_ADVERSARIAL_WINDOWS + (sk.TILE_MAX_WINDOW,)):
        d, c = radix_adversarial(w, seed=60 + i)
        errs["radix"][f"adversarial_w{w}"], _ = smoke.compare(
            f"adversarial_w{w}", "radix", torch.tensor(d, device=dev), torch.tensor(c, device=dev))
    for i, w in enumerate(LOOP_ADVERSARIAL_WINDOWS):
        d, c = radix_adversarial(w, seed=80 + i)
        errs["loop"][f"adversarial_w{w}"], _ = smoke.compare(
            f"adversarial_w{w}", "loop", torch.tensor(d, device=dev), torch.tensor(c, device=dev))
    # pairwise: each size of its register path and the switch to the tiled one.
    for i, w in enumerate(PAIRWISE_WINDOWS):
        d, c = edge_case(w, seed=90 + i)
        errs["pairwise"][f"edge_w{w}"], _ = smoke.compare(
            f"edge_w{w}", "pairwise", torch.tensor(d, device=dev), torch.tensor(c, device=dev))
        d, c = radix_adversarial(w, seed=100 + i)
        d = with_infinities(d, seed=110 + i)
        errs["pairwise"][f"adversarial_w{w}"], _ = smoke.compare(
            f"adversarial_w{w}", "pairwise", torch.tensor(d, device=dev), torch.tensor(c, device=dev))
    torch.cuda.empty_cache()
    max_abs_err = {mode: max(e.values()) for mode, e in errs.items()}
    smoke.emit("kernel_vs_plain", medians_equal_as_int32=True, equal_by_value_across=by_value,
               weight_rtol_of_abs_sum={w: weight_rtol(w) for w in (256, 512, 1024)},
               max_abs_weight_err=errs)

    # 4. main path (config 4) --------------------------------------------------
    names = tuple(f"sig{s}" for s in range(S))
    rows = ring  # [W, R, S]: row i is step i's [R, S] timings, already on the card
    path_launches = dict.fromkeys(sk.MODES, 0)

    def drive(mt, rows):
        state = mt.init_state()
        w = rows.shape[0]
        for i in range(w):
            mt.push(state, rows[i])
        state, sc1 = mt.score(state)
        rep1 = mt.materialize(sc1)
        for i in range(w + 5):  # more than W pushes: the ring wraps
            mt.push(state, rows[i % w])
        state, sc2 = mt.score(state)
        rep2 = mt.materialize(sc2)
        return state, (sc1, sc2), (rep1, rep2)

    def check_masks(label, scores, other, other_label, n_reports=2):
        perf_err = {}
        for k in range(n_reports):
            a, b = scores[k], other[k]
            if not torch.equal(a.straggler.cpu(), b.straggler.cpu()):
                raise AssertionError(f"{label} report {k + 1}: straggler mask differs from {other_label}")
            diff = (a.perf.cpu() - b.perf.cpu()).abs()
            if not bool((diff <= 1e-5 * b.perf.cpu().abs()).all()):
                raise AssertionError(f"{label} report {k + 1}: perf differs from {other_label} by {diff.max()}")
            perf_err[f"{other_label}_report{k + 1}"] = float(diff.max())
        return perf_err

    mt = MeshTelemetry(R, signal_names=names, window=W)
    if not mt.use_kernel or mt.device.type != "cuda":
        raise AssertionError(f"main path is not on a kernel: {mt.device}, {mt.kernel_mode}")
    sk.reset_launches()
    state, scores, reports = drive(mt, rows)
    torch.cuda.synchronize()
    launches = dict(fused_median_weights.launches_by_mode)
    if launches[mt.kernel_mode] < 1:
        raise AssertionError(f"the main path launched the {mt.kernel_mode} kernel no time")
    for mode, n in launches.items():
        path_launches[mode] += n

    mt_sort = MeshTelemetry(R, signal_names=names, window=W, use_kernel=False)
    _, scores_sort, _ = drive(mt_sort, rows)
    mt_cpu = MeshTelemetry(R, signal_names=names, window=W, device="cpu")
    _, scores_cpu, _ = drive(mt_cpu, rows.cpu())
    perf_err = {**check_masks("main", scores, scores_sort, "sort_on_card"),
                **check_masks("main", scores, scores_cpu, "plain_on_cpu")}

    rep1, rep2 = reports
    pred = flagged(rep1, R)
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
    smoke.emit("main_path", ranks=R, signals=S, window=W, kernel_mode=mt.kernel_mode,
               launches=launches, f1=f1_1, flagged=int(pred.sum()), truth=int(truth.sum()),
               perf_max_abs_diff=perf_err, ewma_slow_mean=[float(ewma1[truth].mean()),
                                                          float(ewma2[truth].mean())])

    # 5. long-window path ------------------------------------------------------
    def drive_long(mt, rows):
        state = mt.init_state()
        for i in range(LONG_W):
            mt.push(state, rows[i])
        state, sc1 = mt.score(state)
        rep1 = mt.materialize(sc1)
        for i in range(LONG_PARTIAL):  # a window filled 300 of 512
            mt.push(state, rows[i])
        counts2 = int(state.counts.max())
        state, sc2 = mt.score(state)
        rep2 = mt.materialize(sc2)
        return counts2, (sc1, sc2), (rep1, rep2)

    mt_long = MeshTelemetry(R, signal_names=names, window=LONG_W)
    if mt_long.kernel_mode != "radix":
        raise AssertionError(f"the long-window path runs {mt_long.kernel_mode}, not radix")
    sk.reset_launches()
    filled2, long_scores, long_reports = drive_long(mt_long, long_ring)
    torch.cuda.synchronize()
    long_launches = dict(fused_median_weights.launches_by_mode)
    if long_launches["radix"] < 1:
        raise AssertionError("the long-window path launched the radix kernel no time")
    for mode, n in long_launches.items():
        path_launches[mode] += n
    if filled2 != LONG_PARTIAL:
        raise AssertionError(f"the second long-window report saw counts {filled2}")

    mt_long_sort = MeshTelemetry(R, signal_names=names, window=LONG_W, use_kernel=False)
    _, long_sort, _ = drive_long(mt_long_sort, long_ring)
    long_err = check_masks("long", long_scores, long_sort, "sort_on_card")
    long_f1 = [f1(flagged(rep, R), long_truth) for rep in long_reports]
    if min(long_f1) < 0.99:
        raise AssertionError(f"long-window F1 {long_f1} against the seeded truth is below 0.99")
    small_rows = long_ring[:, :CPU_RANKS].contiguous()
    mt_small = MeshTelemetry(CPU_RANKS, signal_names=names, window=LONG_W)
    mt_small_cpu = MeshTelemetry(CPU_RANKS, signal_names=names, window=LONG_W,
                                 device="cpu", use_kernel=True)
    _, small_scores, _ = drive_long(mt_small, small_rows)
    t0 = time.perf_counter()
    _, small_cpu, _ = drive_long(mt_small_cpu, small_rows.cpu())
    cpu_seconds = time.perf_counter() - t0
    long_err.update(check_masks("long 256 ranks", small_scores, small_cpu, "plain_on_cpu_256"))
    del mt_long_sort, long_sort, small_rows
    torch.cuda.empty_cache()
    smoke.emit("long_window_path", ranks=R, signals=S, window=LONG_W,
               ring_bytes=long_ring.numel() * 4, kernel_mode=mt_long.kernel_mode,
               launches=long_launches, report2_counts=filled2, f1=long_f1,
               flagged=[int(flagged(rep, R).sum()) for rep in long_reports],
               truth=int(long_truth.sum()), perf_max_abs_diff=long_err,
               cpu_ranks=CPU_RANKS, cpu_kernel_mode=mt_small_cpu.kernel_mode,
               cpu_run_seconds=cpu_seconds)

    # 6. explicit modes ----------------------------------------------------------
    explicit = {}
    mt_rows = MeshTelemetry(R, signal_names=names, window=W, use_kernel=False)
    st_rows = mt_rows.init_state()
    for i in range(W):
        mt_rows.push(st_rows, rows[i])
    for mode in [m for m in sk.MODES if path_launches[m] == 0]:
        gen = ReportGenerator(R, S, device=dev)
        sk.reset_launches()
        med, wt = fused_median_weights(st_rows.data.permute(1, 2, 0), st_rows.counts, mode=mode)
        rep = gen.generate_summary_report(med, wt, st_rows.counts, names)
        torch.cuda.synchronize()
        n = fused_median_weights.launches_by_mode[mode]
        if n < 1:
            raise AssertionError(f"the explicit {mode} path launched its kernel no time")
        path_launches[mode] += n
        pred_m = flagged(rep, R)
        if not np.array_equal(pred_m, flagged(rep1, R)):
            raise AssertionError(f"the explicit {mode} report flags other ranks than the main path")
        explicit[mode] = {"launches": n, "f1": f1(pred_m, truth), "flagged": int(pred_m.sum())}
    smoke.emit("explicit_mode_path", ranks=R, signals=S, window=W, modes=explicit)

    # 7. times -------------------------------------------------------------------
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    ops_per_s, ops_rate_source = compare_rate(torch)

    def bounds(view, ops):
        r, s, w = view.shape
        bytes_moved = (r * s * w + r * s + 2 * r * s) * 4
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        return {"bytes": bytes_moved, "ops": ops, "bytes_bound_ms": bytes_ms,
                "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    def path_times(mt, rows, reps_push):
        st = mt.init_state()
        w = rows.shape[0]
        for i in range(w):
            mt.push(st, rows[i])
        full_counts = st.counts.clone()
        push_ms = smoke.time_loop(lambda i: mt.push(st, rows[i % w]), reps=reps_push)
        st.counts.copy_(full_counts)
        score_ms = time_each(lambda: mt.score(st), reps=20, flush=flush)
        wall = []
        for _ in range(5):
            t0 = time.perf_counter()
            mt.generate_report(st)
            wall.append((time.perf_counter() - t0) * 1e3)
        return st, {"push_ms_per_step": push_ms, "score_ms_per_report": score_ms,
                    "report_wall_ms_median": statistics.median(wall),
                    "amortised_ms_per_step": push_ms + score_ms / REPORT_INTERVAL}

    # Every CUDA-event time first, before the process's first profiler session
    # (device_ms, the sweep, the breakdown): the spans users pay, as they pay them.
    mt_t = MeshTelemetry(R, signal_names=names, window=W)
    st, t4 = path_times(mt_t, rows, reps_push=500)
    mt_lt = MeshTelemetry(R, signal_names=names, window=LONG_W)
    st_l, tl = path_times(mt_lt, long_ring, reps_push=200)
    view4, counts4 = st.data.permute(1, 2, 0), st.counts
    view_l, counts_l = st_l.data.permute(1, 2, 0), st_l.counts
    # The radix launch on windows of one value each: no digit round runs, so this is
    # the tile's staging, the register load, the weight and the hi pass alone.
    one_value = torch.ones_like(long_ring).permute(1, 2, 0)

    def nan_masked(view, counts):  # the library's input, made outside the timed call
        valid = torch.arange(view.shape[-1], device=dev) < counts[..., None]
        return torch.where(valid, view, float("nan")).contiguous()

    x_nan = {"config4": nan_masked(view4, counts4), "long": nan_masked(view_l, counts_l)}

    def library(x):
        return (torch.nanquantile(x, 0.5, dim=-1, interpolation="midpoint"),
                torch.nansum(x, dim=-1))

    # (cell, what, mode or None): (fn, reps)
    timed_calls = {
        **{("config4", "kernel", m): (lambda m=m: fused_median_weights(view4, counts4, mode=m), 50)
           for m in ("loop", "pairwise")},
        **{("config4", "plain", m): (lambda m=m: sk.PLAIN_VERSIONS[m](view4, counts4), 10)
           for m in ("loop", "pairwise")},
        ("config4", "sort", None): (lambda: (masked_median(view4, counts4),
                                             masked_total(view4, counts4)), 20),
        ("config4", "nanquantile", None): (lambda: library(x_nan["config4"]), 10),
        ("long", "kernel", "radix"): (
            lambda: fused_median_weights(view_l, counts_l, mode="radix"), 30),
        ("long", "plain", "radix"): (lambda: sk.PLAIN_VERSIONS["radix"](view_l, counts_l), 5),
        ("long", "radix_no_round", None): (
            lambda: fused_median_weights(one_value, counts_l, mode="radix"), 30),
        ("long", "sort", None): (lambda: (masked_median(view_l, counts_l),
                                          masked_total(view_l, counts_l)), 10),
        ("long", "nanquantile", None): (lambda: library(x_nan["long"]), 10),
    }
    events = {k: time_each(fn, reps, flush) for k, (fn, reps) in timed_calls.items()}
    device = {k: kernel_sweep.device_ms(fn, reps, flush) for k, (fn, reps) in timed_calls.items()}
    del one_value, x_nan

    timed = {k: {"ms": device[k], "events_ms": events[k]} for k in timed_calls}

    def times_of(cell):
        """``{what: times}`` of a cell, ``{what: {mode: times}}`` where a mode runs."""
        out = {}
        for (c, what, mode), t in timed.items():
            if c == cell:
                if mode is None:
                    out[what] = t
                else:
                    out.setdefault(what, {})[mode] = t
        return out

    cell_of = {"loop": "config4", "pairwise": "config4", "radix": "long"}
    # Operations: the loop kernel's network does two FMNMX per compare-exchange; the
    # pairwise kernel's register path one compare per pair of slots (the TPU kernel
    # and the tiled path compare every ordered pair, W^2 per window).
    pairwise_ops = R * S * pairwise_compares(W, sk.PAIRWISE_REGISTER_MAX_WINDOW)
    bound = {"loop": bounds(view4, R * S * 2 * bitonic_comparators(sk.network_size(W))),
             "pairwise": bounds(view4, pairwise_ops)}
    smoke.emit("times", ranks=R, signals=S, window=W, report_interval=REPORT_INTERVAL, **t4,
               **times_of("config4"), compares_per_s=ops_per_s,
               compares_per_s_source=ops_rate_source,
               bound={m: bound[m] for m in ("loop", "pairwise")})
    # The radix kernel's key operations on this data (its source's head says how
    # they are counted): 2 per candidate of each digit round, 3 per valid key.
    rounds, examined = digit_work(view_l, counts_l)
    radix_ops = int(2 * examined.sum() + 3 * counts_l.clamp(0, LONG_W).sum())
    bound["radix"] = bounds(view_l, radix_ops)
    smoke.emit("times", ranks=R, signals=S, window=LONG_W, report_interval=REPORT_INTERVAL,
               **tl, kernel_mode=mt_lt.kernel_mode, **times_of("long"), bound=bound["radix"],
               radix_rounds={"mean": float(rounds.double().mean()), "max": int(rounds.max()),
                             "histogram": {str(i): int(n) for i, n in
                                           enumerate(torch.bincount(rounds).tolist()) if n},
                             "examined_per_key": float(examined.sum()) / view_l.numel()})
    del rounds, examined
    torch.cuda.empty_cache()

    # 8. sweep -------------------------------------------------------------------
    t0 = time.perf_counter()
    sweep = kernel_sweep.run()
    smoke.emit("sweep", seconds=time.perf_counter() - t0, **sweep,
               profiler_sessions_rerun=kernel_sweep.device_ms.reruns,
               defaults={"loop_max_window": sk.DEFAULT_MAX_WINDOW,
                         "radix_auto": sk.DEFAULT_RADIX_AUTO})

    # 9. breakdown ---------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    def breakdown(label, mt, st, score_ms, reports=5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reports):
                mt.score(st)
            torch.cuda.synchronize()
        rows_by_time = []
        for evt in prof.key_averages():
            dev_us = getattr(evt, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "cuda_time_total", 0)
            if dev_us and evt.key and not evt.key.startswith("aten::"):
                rows_by_time.append((evt.key, dev_us / reports / 1e3, evt.count // reports))
        rows_by_time.sort(key=lambda r: -r[1])
        busy_ms = sum(ms for _, ms, _ in rows_by_time)
        smoke.emit(
            "breakdown", path=label, reports=reports,
            device_busy_ms_per_report=busy_ms or "not measured",
            # share of the event-timed report (phase times) in which the card ran no kernel
            idle_share=1.0 - busy_ms / score_ms if busy_ms else "not measured",
            device_ms_per_report_by_kernel=[
                {"kernel": k[:80], "ms": ms, "launches": n} for k, ms, n in rows_by_time[:12]
            ] or "not measured",
        )

    breakdown("config4", mt_t, st, t4["score_ms_per_report"])
    breakdown("long_window", mt_lt, st_l, tl["score_ms_per_report"], reports=3)

    # 10. detector path; 11. group path ------------------------------------------
    del mt_t, st, mt_lt, st_l, long_ring
    torch.cuda.empty_cache()
    path_launches["loop"] += detector_path(smoke, rows, names, flagged(rep1, R))
    group_path(smoke, rows.permute(1, 2, 0), torch.full((R, S), W, dtype=torch.int32, device=dev),
               names)

    kernels = []
    for mode in sk.MODES:
        b = bound[mode]
        kernels.append(dict(
            KERNELS[mode], launches=path_launches[mode], max_abs_err=max_abs_err[mode],
            ms=timed[(cell_of[mode], "kernel", mode)]["ms"],
            events_ms=timed[(cell_of[mode], "kernel", mode)]["events_ms"],
            plain_ms=timed[(cell_of[mode], "plain", mode)]["ms"],
            plain_events_ms=timed[(cell_of[mode], "plain", mode)]["events_ms"],
            bound_ms=b["bound_ms"], bound_by=b["bound_by"],
            library_ms=timed[(cell_of[mode], "nanquantile", None)]["ms"],
            shape=[R, S, LONG_W if mode == "radix" else W],
            verdict="medians equal bit for bit as int32; weights within weight_rtol(W) "
                    "of the window's sum of |x|",
            card=card,
        ))
    print(json.dumps({"kernels": kernels, "seconds": time.perf_counter() - t_start}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
