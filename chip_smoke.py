#!/usr/bin/env python3
"""Drive the PyTorch port's straggler-telemetry, in-process restart, checkpoint and
in-job restart paths on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA card
and the CUDA toolkit (``nvcc``), builds the port's three window-reduction kernels
(``loop``, ``pairwise``, ``radix``) and its fault kernels (``csrc/faults.cu``) from the
checkout's sources, all ``nvcc`` runs started together, and runs these phases, each
printing one JSON line that carries the card's name and power limit:

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
   config 4 (5, ``loop``) and at W = 512 (3, ``radix``). Each session opens as a
   ``DeviceTimeProfiler`` window does (a synchronize, then its ``SETTLE_S`` pause),
   and the mode's kernel records must number its launches and the reports run.
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
12. ``restart_path``: in-process restart on the card, in four parts.
   (a) ``inprocess.Wrapper`` (``AbortTorchDistributed``, ``CudaHealthCheck``) around
   config 4's detector workload: 200 steps of ``run_training`` per iteration with the
   straggler callback (a profiler window every 50 steps), one push per step and a
   ``loop`` report every 100, in a one-process NCCL group that
   ``platform.distributed.initialize`` builds anew each iteration on a new port.
   Iteration 0 raises ``InjectedFault`` in step 150, a profiled one; iteration 1
   completes. Iterations must be [0, 1]; iteration 1's group new, NCCL, its
   ``all_reduce`` right; the ``loop`` launches rise in both; iteration 1's last report
   flags the main path's ranks; iteration 1's four profiler windows open; and
   ``torch.cuda.memory_allocated()`` at its first step lie within 1 MiB of iteration
   0's. Printed: the wall time from the raise to iteration 1's first step, split into
   abort, health check, re-init and the rest; it must be shorter than (c)'s fresh
   interpreter's time to the card.
   (b) ``DEVICE_HANG`` on two ranks of the one card, fresh interpreters, no group
   between them: rank 1 launches the spin kernel in iteration 0 and its monitor
   process must kill it (soft 1.5 s, hard 4 s) between hard - heartbeat interval and
   hard + 1 s after its last ping; rank 0 must end at iteration 1, world 1, having
   launched small kernels while its peer spun. Printed: last ping to kill.
   Then three fresh interpreters together: (c) a fresh process must launch and
   synchronize (the spinning context died with its process); its time from launch to
   that first synchronize is printed, the least a process restart pays. Beside it,
   ``DEVICE_ERROR`` on one rank: the trap kernel's sticky error must turn the
   liveness probe ``False`` and ``CudaHealthCheck`` into ``HealthCheckError``, and the
   Wrapper must exclude the rank with attempts [0]. And (d) one rank under the
   Wrapper (its default timeouts) whose ``all_reduce`` in a one-process NCCL group
   (2 s timeout) is queued behind 6 s of ``torch.cuda._sleep``: NCCL's watchdog
   times it out, the step raises on seeing it unfinished, and the rank must live
   through the abort and finish iteration 1 in a new NCCL group within the
   Wrapper's barrier timeout (120 s). Printed: that restart's wall time, split.
   The fault kernels' build seconds and ptxas lines are on this line; they are not
   TPU kernels and have no row on the ``kernels`` line. The processes the run
   started must be gone 30 s after the phase (what is left is killed and counted):
   ``main`` stamps the run in the environment (``RUN_ENV``) and starts over in its
   own place, so every process it starts holds the stamp, and only those are reaped.
13. ``checkpoint_path``: local and async checkpointing on the card, on the one-rank
   shard of BASELINE config 5's Llama-3-8B that a 16-rank job holds (each leaf of
   ``init_params`` cut to 1/16 along its leading axis: 2 layers, ``embed`` 8016 rows,
   ``lm_head`` 256 rows, ``final_norm`` 256): f32 parameters, AdamW's ``mu`` and ``nu``
   (6,022,695,936 B), a step counter and a bf16 copy of ``embed``, from a seeded CUDA
   generator. It first prints the host memory available and the free disk of its
   temporary directory, and fails if they cannot hold what it writes (the state is
   never shrunk). First the link's yardstick: a plain ``copy_`` of the same bytes into
   one pinned buffer. (a) ``LocalCheckpointManager.save(..., is_async=True)`` three
   times, every leaf updated in place (``add_`` of seeded noise) right after each
   ``save()`` returns; each container must load onto the card bit-identical (as integer
   views) to a blocking host copy taken before its save; device memory after finalize
   within 1 MiB of before; the staging pool at least 1 hit and at most 2 misses. Then
   the blocking engine (``pipelined=False``: ``copy_tensors_to_host``, then the save)
   on the same state; the pipelined foreground window must be at most 0.25x its
   (``tests/checkpoint/test_ckpt_save_perf.py``'s gate). Printed: the foreground window
   (host clock and CUDA events), save to finalized container, the D2H GB/s (the side
   stream's device time) beside the yardstick's, the background stream's GB/s, the
   blocking engine's write GB/s, the pool, device memory, and the snapshot design's
   cost (its extra device bytes and the device time of its clones, which the next
   step waits behind). (b) Two ranks in fresh interpreters on the one card, each
   holding a 1/32 shard (3,011,347,968 B), save once with ``CliqueReplicationStrategy``
   over the port's store and a ``TreeLayout``; rank 1's directory is wiped and both
   restore onto the card in fresh interpreters, rank 1 from rank 0's mirror,
   bit-identical; then ``load_resharded_tree`` of the two containers on rank 0's disk
   onto one rank must equal their concatenation; no process may be left. (c)
   ``run_training`` with ``HierarchicalCheckpointCallback`` (local tier every 2 steps,
   async) over 4 steps of (a)'s state with in-place updates; ``restore_latest`` must
   bring back step 4's values on the card (6 steps before ``injob_path`` was added; cut
   to keep the script within its time). The checkpoint path launches none of the
   median kernels; their counts are zeroed before it and printed.
14. ``injob_path``: fault tolerance and the in-job restart on the card. Each scenario
   is a fresh process tree: the port's launcher (``python -m
   tpu_resiliency_torch.launcher.launch --nproc-per-node 1 --monitor-interval 0.1
   --rdzv-last-call 0.2``) as a subprocess, its processes sampled on a thread (which
   hold a ``/dev/nvidia<N>``, and ``nvidia-smi``'s compute pids and MiB) and reaped
   after it. (a) ``tpu_resiliency_torch.examples.resilient_training`` at config 4's
   full width (a push per step, a ``loop`` report every 100) carrying the 1/32
   Llama-3-8B shard of ``checkpoint_path`` (b) (3,011,347,968 B), with the FT,
   straggler and checkpoint callbacks: a local checkpoint every 100 steps; at step 150
   of round 0, once the step-100 container is finalized, ``DEVICE_HANG``, so the
   heartbeats stop (``--ft-param-rank_heartbeat_timeout 5``,
   ``workload_check_interval 0.5``, no stack-dump grace). The monitor must send its
   kill between 5 and 6.5 s after the last heartbeat, and the worker be gone within
   the agent's 15 s grace after it; round 1, a cold respawn, must restore
   the step-100 state bit-identical (as integer views) to a replay of the seed, run to
   step 300 with the straggler masks of an uninterrupted run, and run no ``nvcc``.
   Printed: the restart cut from the event stream into detect, kill signal, death,
   teardown, rendezvous, spawn and startup, CUDA context and kernel load, restore and
   first step;
   the dead worker's card MiB and how long its pid stayed on ``nvidia-smi``; round 1's
   first and median step. (b) The same with ``--warm-spares 1 --warm-spare-warmup
   runtime``: round 1 must be the promoted spare, which held no card before its
   promotion. (c) ``tpu_resiliency_torch.examples.layered_restart`` at config 4 under
   the Wrapper: ``DEVICE_ERROR`` at step 150 of round 0; ``CudaHealthCheck`` must fail,
   the process exit with ``HealthCheckError``, and round 1, a new process, complete with
   the uninterrupted run's step-100 mask; the ``[NestedRestarter]`` lines must name
   both layers. In every scenario no agent, monitor or spare may hold the card.
   (d) ``CudaRuntimeCheck`` in this process: healthy; unhealthy past a memory-pressure
   threshold set just below the pressure an allocation makes; unhealthy with
   ``expect_devices`` one past the count. The workers' ``loop`` launches go on the
   ``kernels`` line.

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
RESTART_STEPS = 200  # steps per iteration of restart_path's wrapped workload
RESTART_FAULT_STEP = 150  # iteration 0 raises in this step, a profiled one
RUN_ENV = "CHIP_SMOKE_RUN"  # this run's stamp, in the environment of all it starts
# The kernels of csrc/median_weights.cu: the register network (W <= 64) and the
# general path; ``loop`` launches one of them per report.
LOOP_KERNEL_FUNCTIONS = ("median_weights_network_kernel", "median_weights_loop_kernel")
RADIX_KERNEL_FUNCTIONS = ("median_weights_radix_kernel",)
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


# -- the checkpoint state -----------------------------------------------------------

#: Llama-3-8B's widths, the leaf shapes of ``TransformerConfig.llama3_8b()`` and
#: ``init_params`` (``tpu_resiliency/models/transformer.py:52-99``), copied as numbers.
LLAMA3_8B = dict(d=4096, q=4096, kv=1024, ff=14336, vocab=128256)
#: The 1/16 shard of a 16-rank job (BASELINE config 5): each leaf cut along its
#: leading axis; the 1/32 shard each of ``checkpoint_path`` (b)'s two ranks holds.
SHARD_16 = dict(LLAMA3_8B, n_layers=2, embed_rows=8016, head_rows=256, norm=256)
SHARD_32 = dict(LLAMA3_8B, n_layers=1, embed_rows=4008, head_rows=128, norm=128)
INT_VIEWS = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def llama_shard_shapes(n_layers, d, q, kv, ff, vocab, embed_rows, head_rows, norm):
    """One rank's shard of the Llama parameter tree: ``n_layers`` of the stacked
    layers, the first ``embed_rows`` of the embedding, ``head_rows`` of the head's
    leading axis and ``norm`` of the final norm; every other axis at full width."""
    L = n_layers
    layers = {"attn_norm": (L, d), "wq": (L, d, q), "wk": (L, d, kv), "wv": (L, d, kv),
              "wo": (L, q, d), "mlp_norm": (L, d), "w_gate": (L, d, ff), "w_up": (L, d, ff),
              "w_down": (L, ff, d)}
    return {"embed": (embed_rows, d), "layers": layers, "final_norm": (norm,),
            "lm_head": (head_rows, vocab)}


def ckpt_state(torch, shapes, seed, device, bf16=True):
    """A train state on ``device``: f32 parameters of ``shapes`` plus AdamW's ``mu`` and
    ``nu``, a step counter, and (``bf16``) a bf16 copy of the embedding; values from a
    generator seeded with ``seed`` on that device."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return torch.randn(node, generator=gen, device=device)

    state = {"params": make(shapes), "opt": {"mu": make(shapes), "nu": make(shapes)}, "step": 0}
    if bf16:
        state["embed_bf16"] = state["params"]["embed"].to(torch.bfloat16)
    return state


def ckpt_leaves(state):
    """The state's tensors in the order the checkpoint pops them."""
    from tpu_resiliency_torch.checkpoint.state_dict import tree_flatten

    return [x for x in tree_flatten(state)[0] if hasattr(x, "data_ptr")]


def ckpt_step(torch, state, seed):
    """An optimizer step's worth of in-place updates: ``add_`` of seeded noise to every
    leaf, and the step counter."""
    leaves = ckpt_leaves(state)
    gen = torch.Generator(device=leaves[0].device).manual_seed(seed)
    for t in leaves:
        t.add_(torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype))
    state["step"] += 1


def ckpt_host_copy(torch, state):
    """A blocking host copy of every leaf, for checking a save (outside its timing)."""
    return [t.detach().to("cpu") for t in ckpt_leaves(state)]


def ckpt_nbytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in ckpt_leaves(state))


def ckpt_assert_equal(torch, tree, copy, label):
    """Every leaf of ``tree`` equals ``copy`` bit for bit (compared as integer views)."""
    leaves = ckpt_leaves(tree)
    if len(leaves) != len(copy):
        raise AssertionError(f"{label}: {len(leaves)} leaves, the copy holds {len(copy)}")
    for i, (a, b) in enumerate(zip(leaves, copy)):
        iv = getattr(torch, INT_VIEWS[a.element_size()])
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(iv), b.to(a.device).view(iv)):
            raise AssertionError(f"{label}: leaf {i} {tuple(a.shape)} {a.dtype} differs from "
                                 f"the values at its save")


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


# The children of ``restart_path``. Each is a fresh interpreter started with
# ``subprocess``, never ``fork``: this process holds a CUDA context, which a forked
# child cannot use. Each prints one ``RESULT {json}`` line.
RESTART_WRAPPER_KW = dict(monitor_interval=0.1, last_call_wait=0.1, heartbeat_interval=0.2)
HANG_TIMEOUTS = dict(soft_timeout=1.5, hard_timeout=4.0, heartbeat_timeout=15.0,
                     barrier_timeout=60.0, completion_timeout=60.0)
# Wrapper timeouts of part (d): the Wrapper's defaults, which a real job runs with.
TIMEOUT_WRAPPER_KW = dict(RESTART_WRAPPER_KW, soft_timeout=60.0, hard_timeout=90.0,
                          heartbeat_timeout=30.0, barrier_timeout=120.0,
                          completion_timeout=120.0)
NCCL_GROUP_TIMEOUT_S = 2.0  # part (d)'s group timeout
NCCL_BUSY_S = 6.0  # how long part (d) keeps the card busy ahead of its collective
HANG_CHILD = """
import json, os, sys, threading, time

rank = int(sys.argv[1])
os.environ.update(RANK=str(rank), WORLD_SIZE="2", TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                  TPU_RESILIENCY_STORE_PORT=sys.argv[2])
import torch

from tpu_resiliency_torch.inprocess import CallWrapper, RetryController, Wrapper
from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, inject_fault, launch_spin

dev = torch.device("cuda")
parked = {"launches": 0, "max_ms": 0.0}

def small_launch():
    t0 = time.perf_counter()
    (torch.ones(2, device=dev) + 1).sum().item()
    return (time.perf_counter() - t0) * 1e3

@Wrapper(initialize=RetryController(max_iterations=4), **json.loads(sys.argv[3]))
def train(call: CallWrapper):
    fs = call.frozen_state
    for _ in range(3):
        small_launch()
        call.ping()
    if call.iteration == 0 and fs.initial_rank == 1:
        print("PING " + json.dumps({"t": time.time()}), flush=True)

        def report_spin():  # runs while the main thread waits in the driver
            while launch_spin.launches == 0:
                time.sleep(0.01)
            print("SPIN " + json.dumps({"launches": launch_spin.launches}), flush=True)

        threading.Thread(target=report_spin, daemon=True).start()
        inject_fault(Fault.DEVICE_HANG)  # never returns: pings stop here
    if call.iteration == 0:
        # Small launches while the peer spins: the card time-slices the contexts.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            ms = small_launch()
            parked["launches"] += 1
            parked["max_ms"] = max(parked["max_ms"], ms)
            time.sleep(0.02)
        raise TimeoutError("restart never delivered")
    return {"iteration": call.iteration, "world": fs.active_world_size}

result = train()
print("RESULT " + json.dumps({"rank": rank, "result": result, "parked": parked}), flush=True)
"""
ERROR_CHILD = """
import json, os, sys

os.environ.update(RANK="0", WORLD_SIZE="1", TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                  TPU_RESILIENCY_STORE_PORT=sys.argv[1])
import torch

from tpu_resiliency_torch.exceptions import HealthCheckError
from tpu_resiliency_torch.inprocess import CallWrapper, CudaHealthCheck, RetryController, Wrapper
from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, inject_fault, launch_trap
from tpu_resiliency_torch.platform.device import device_liveness_probe

out = {"probe_before": device_liveness_probe(timeout=15.0)}
check = CudaHealthCheck(timeout=5.0)
attempts = []

@Wrapper(initialize=RetryController(max_iterations=5), health_check=CudaHealthCheck(timeout=5.0),
         **json.loads(sys.argv[2]))
def train(call: CallWrapper):
    attempts.append(call.iteration)
    if call.iteration == 0:
        inject_fault(Fault.DEVICE_ERROR)
        out["probe_after"] = device_liveness_probe(timeout=15.0)
        try:
            check(None)
            out["health_check"] = "passed"
        except HealthCheckError as e:
            out["health_check"] = "HealthCheckError: " + str(e)[:160]
    # The workload's own device use fails on the sticky error.
    return float(torch.ones(2, device="cuda").sum())

try:
    train()
    out["outcome"] = "completed"
except HealthCheckError as e:
    out["outcome"] = "health_excluded"
out.update(attempts=attempts, trap_launches=launch_trap.launches)
print("RESULT " + json.dumps(out), flush=True)
os._exit(0)  # interpreter teardown would touch the lost context again
"""
FRESH_CHILD = """
import json, time
import torch
x = torch.ones(1024, device="cuda")
torch.cuda.synchronize()
t = time.time()  # a fresh interpreter has reached the card
print("RESULT " + json.dumps({"sum": float((x + 1).sum()), "t": t}), flush=True)
"""
TIMEOUT_CHILD = """
import json, logging, os, socket, sys, time

os.environ.update(RANK="0", WORLD_SIZE="1", TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                  TPU_RESILIENCY_STORE_PORT=sys.argv[1])
import torch
import torch.distributed as dist

from tpu_resiliency_torch.inprocess import (
    AbortTorchDistributed, CallWrapper, CudaHealthCheck, RetryController, Wrapper,
)
from tpu_resiliency_torch.platform import distributed

kw = json.loads(sys.argv[2])
spans, seen = {"abort": [], "health_check": [], "reinit": []}, {"teardown_warnings": []}

class Keep(logging.Handler):  # the teardown's warnings go on the result line
    def emit(self, record):
        seen["teardown_warnings"].append(record.getMessage()[:300])

logging.getLogger(distributed.__name__).addHandler(Keep(logging.WARNING))

def timed(name, fn):
    def call(state):
        t0 = time.perf_counter()
        try:
            return fn(state)
        finally:
            spans[name].append((t0, time.perf_counter()))
            if name == "abort":
                seen["abort_method"] = distributed.last_abort_method
    return call

def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]

def sleep_cycles(seconds):
    # torch.cuda._sleep counts clock cycles: rate them on this card first.
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    b.synchronize()
    return int(seconds * 100_000_000 / (a.elapsed_time(b) / 1e3))

@Wrapper(initialize=RetryController(max_iterations=3), abort=timed("abort", AbortTorchDistributed()),
         health_check=timed("health_check", CudaHealthCheck(timeout=30.0)), **kw["wrapper"])
def train(call: CallWrapper):
    it = call.iteration
    seen.setdefault("group_left_open", []).append(distributed.client_active())
    t0 = time.perf_counter()
    distributed.initialize(f"tcp://localhost:{free_port()}", 1, 0, timeout=kw["group_timeout_s"])
    spans["reinit"].append((t0, time.perf_counter()))
    x = torch.full((4,), 3.0, device="cuda")
    if it == 0:
        # The card stays busy past the group's timeout, so NCCL's watchdog times out
        # the collective queued behind; the step sees its work unfinished and raises.
        torch.cuda._sleep(sleep_cycles(kw["busy_s"]))
        work = dist.all_reduce(x, async_op=True)
        queued = time.perf_counter()
        while time.perf_counter() - queued < 1.5 * kw["group_timeout_s"]:
            call.ping()
            time.sleep(0.05)
        if work.is_completed():
            raise AssertionError("the collective finished inside the group's timeout")
        seen["raise"] = time.perf_counter()
        raise TimeoutError("all_reduce did not finish within the group's timeout")
    torch.cuda.synchronize()
    seen["first_step"] = time.perf_counter()
    dist.all_reduce(x)
    out = {"iteration": it, "all_reduce": x.tolist(), "backend": dist.get_backend(),
           "group_left_open": seen["group_left_open"]}
    distributed.shutdown_ordered(call.coord.store, 0, 1, iteration=it)
    return out

out = {"result": train()}
t_raise, t_first = seen["raise"], seen["first_step"]
(a0, a1), = [s for s in spans["abort"] if s[0] >= t_raise]
(h0, h1), = [s for s in spans["health_check"] if s[0] >= t_raise]
r0, r1 = spans["reinit"][1]
restart = t_first - t_raise
out.update(abort_method=seen["abort_method"], teardown_warnings=seen["teardown_warnings"],
           nccl_async_error_handling=os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING"),
           restart_wall_s={"raise_to_first_step": restart, "abort": a1 - a0,
                           "health_check": h1 - h0, "reinit": r1 - r0,
                           "other": restart - (a1 - a0) - (h1 - h0) - (r1 - r0)})
print("RESULT " + json.dumps(out), flush=True)
# On torch 2.11 this process did not exit at interpreter teardown after its group
# had timed out (it was killed at its time limit): leave once the result is out.
os._exit(0)
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_children(children, timeout: float):
    """Start one fresh interpreter per ``(script, argv)``, all together, from this
    checkout; returns ``[(returncode, start and exit wall times, {tag: payloads} of its
    RESULT, PING and SPIN lines, stderr tail)]``, killing any child still alive at
    ``timeout``."""
    import os
    import threading

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here), TPU_RESILIENCY_LOG_LEVEL="WARNING")
    for k in ("RANK", "WORLD_SIZE", "TPU_RESILIENCY_STORE_PORT", "TPU_RESILIENCY_STORE_HOST"):
        env.pop(k, None)
    starts, procs = [], []
    for script, argv in children:
        starts.append(time.time())
        procs.append(subprocess.Popen([sys.executable, "-c", script, *map(str, argv)], cwd=here,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    exits, outs = [None] * len(procs), [None] * len(procs)

    def wait(i, p):
        try:
            outs[i] = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            outs[i] = p.communicate()
        exits[i] = time.time()

    threads = [threading.Thread(target=wait, args=(i, p)) for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    def tagged(out):
        lines = {}
        for ln in out.splitlines():
            tag, _, rest = ln.partition(" ")
            if tag in ("RESULT", "PING", "SPIN"):
                lines.setdefault(tag, []).append(json.loads(rest))
        return lines

    return [(p.returncode, (starts[i], exits[i]), tagged(outs[i][0]), outs[i][1][-1500:])
            for i, p in enumerate(procs)]


def stray_processes() -> list[int]:
    """Processes this run started that outlive their phase, the Wrapper's monitor
    daemons above all (double-forked, so no longer our children): those whose
    environment holds this run's stamp (``RUN_ENV``, set by :func:`main` before the
    run starts, so every process it starts inherits it). This process is left out."""
    import os

    token = os.environ.get(RUN_ENV)
    if not token:
        return []
    stamp = f"{RUN_ENV}={token}".encode()
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit() or int(entry.name) == os.getpid():
            continue
        try:
            env = (entry / "environ").read_bytes().split(b"\0")
        except OSError:
            continue
        if stamp in env:
            found.append(int(entry.name))
    return found


def reap_strays(timeout: float) -> list[int]:
    """Wait up to ``timeout`` s for :func:`stray_processes` to exit on their own (a
    monitor leaves once its job is done), then SIGKILL what is left; returns those
    pids."""
    import os
    import signal

    deadline = time.monotonic() + timeout
    while (left := stray_processes()) and time.monotonic() < deadline:
        time.sleep(0.2)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return left


def restart_in_process(smoke, rows, names, main_mask):
    """``restart_path`` part 1: the Wrapper around config 4's detector workload at
    full width, a one-process NCCL group per iteration; iteration 0 raises inside a
    profiled step, iteration 1 completes. Returns the fields of the phase's line."""
    import os

    import torch
    import torch.distributed as dist

    from tpu_resiliency_torch.inprocess import (
        AbortTorchDistributed,
        CallWrapper,
        CudaHealthCheck,
        RetryController,
        Wrapper,
    )
    from tpu_resiliency_torch.inprocess.tools.inject_fault import InjectedFault
    from tpu_resiliency_torch.integrations import (
        LoopContext,
        StragglerDetectionCallback,
        run_training,
    )
    from tpu_resiliency_torch.ops import scoring_kernels as sk
    from tpu_resiliency_torch.platform import distributed
    from tpu_resiliency_torch.telemetry import Detector, MeshTelemetry
    from tpu_resiliency_torch.telemetry.device_profiler import profiler_running

    dev = torch.device("cuda")
    seen = {"memory": {}, "loop_launches": {}, "windows": {}, "groups": {}, "t": {}}
    spans = {"abort": [], "health_check": [], "reinit": []}

    class Windows(StragglerDetectionCallback):
        """Keeps the steps whose profiler window closed with samples."""

        def _fold_profiler_window(self):
            out = super()._fold_profiler_window()
            seen["windows"].setdefault(self.iteration, []).append(self._step_count - 1)
            return out

    def timed(name, fn):
        def call(state):
            t0 = time.perf_counter()
            try:
                return fn(state)
            finally:
                spans[name].append((t0, time.perf_counter()))
        return call

    @Wrapper(
        initialize=RetryController(max_iterations=3),
        abort=timed("abort", AbortTorchDistributed()),
        health_check=timed("health_check", CudaHealthCheck(timeout=30.0)),
        soft_timeout=60.0, hard_timeout=90.0, heartbeat_timeout=60.0,
        barrier_timeout=120.0, completion_timeout=120.0, **RESTART_WRAPPER_KW,
    )
    def train(call: CallWrapper):
        it = call.iteration
        if profiler_running() or Detector.initialized or distributed.client_active():
            raise AssertionError(f"iteration {it} starts with a profiler session, the "
                                 f"Detector or a process group left open")
        t0 = time.perf_counter()
        port = free_port()
        distributed.initialize(f"tcp://localhost:{port}", 1, 0, timeout=60.0)
        spans["reinit"].append((t0, time.perf_counter()))
        group = dist.group.WORLD
        probe = torch.full((4,), 3.0, device=dev)
        dist.all_reduce(probe)
        seen["groups"][it] = {"group": group, "port": port, "backend": dist.get_backend(group),
                              "all_reduce": probe.tolist()}
        mt = MeshTelemetry(R, signal_names=names, window=W)
        reports = []
        start_loop = sk.fused_median_weights.launches_by_mode["loop"]

        def step(state, i):
            if i == 0:
                torch.cuda.synchronize()
                seen["t"].setdefault("first_step", {})[it] = time.perf_counter()
                seen["memory"][it] = torch.cuda.memory_allocated()
            mt.push(state, rows[i % W])
            if i % REPORT_INTERVAL == 0:
                state, rep = mt.generate_report(state)
                reports.append(rep)
            if it == 0 and i == RESTART_FAULT_STEP:
                seen["loop_launches"][it] = (sk.fused_median_weights.launches_by_mode["loop"]
                                             - start_loop)
                seen["t"]["raise"] = time.perf_counter()
                raise InjectedFault(f"injected at step {i} of iteration {it}")
            torch.cuda.synchronize()  # the step's loss read
            return state

        cb = Windows(report_time_interval=3600.0, profile_programs_every=PROFILE_EVERY,
                     profile_ops=True)
        cb.iteration = it
        ctx = run_training(step, mt.init_state(), RESTART_STEPS, callbacks=[cb],
                           ctx=LoopContext(rank=0, world_size=1))
        seen["loop_launches"][it] = sk.fused_median_weights.launches_by_mode["loop"] - start_loop
        distributed.shutdown_ordered(call.coord.store, 0, 1, iteration=it)
        return {"iteration": it, "steps": ctx.step, "mask": flagged(reports[-1], R)}

    env_keys = ("RANK", "WORLD_SIZE", "TPU_RESILIENCY_STORE_HOST", "TPU_RESILIENCY_STORE_PORT")
    saved = {k: os.environ.get(k) for k in env_keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", TPU_RESILIENCY_STORE_HOST="127.0.0.1",
                      TPU_RESILIENCY_STORE_PORT=str(free_port()))
    try:
        result = train()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    g0, g1 = seen["groups"][0], seen["groups"][1]
    if result["iteration"] != 1 or sorted(seen["groups"]) != [0, 1]:
        raise AssertionError(f"iterations {sorted(seen['groups'])}, final {result['iteration']}")
    if g1["group"] is g0["group"] or g1["port"] == g0["port"] or g1["backend"] != "nccl" \
            or g1["all_reduce"] != [3.0] * 4:
        raise AssertionError(f"iteration 1's group is not a new, working NCCL group: {g1}")
    if not all(seen["loop_launches"].get(i, 0) > 0 for i in (0, 1)):
        raise AssertionError(f"loop launches per iteration {seen['loop_launches']}")
    if not np.array_equal(result["mask"], main_mask):
        raise AssertionError("iteration 1's final report flags other ranks than the main path")
    want_windows = list(range(0, RESTART_STEPS, PROFILE_EVERY))
    if seen["windows"].get(1) != want_windows:
        raise AssertionError(f"iteration 1's profiler windows closed at {seen['windows'].get(1)}, "
                             f"want {want_windows}")
    mem = seen["memory"]
    if abs(mem[1] - mem[0]) > 1 << 20:
        raise AssertionError(f"memory at iteration 1's first step {mem[1]} B against "
                             f"{mem[0]} B at iteration 0's")
    t_raise, t_first = seen["t"]["raise"], seen["t"]["first_step"][1]
    (a0, a1), = [s for s in spans["abort"] if s[0] >= t_raise]
    (h0, h1), = [s for s in spans["health_check"] if s[0] >= t_raise]
    r0, r1 = spans["reinit"][1]
    restart_s = t_first - t_raise
    return dict(
        ranks=R, signals=S, window=W, steps_per_iteration=RESTART_STEPS,
        fault_step=RESTART_FAULT_STEP, iterations=[0, 1],
        loop_launches_by_iteration=seen["loop_launches"],
        profiler_windows_by_iteration=seen["windows"],
        groups=[{"port": g["port"], "backend": g["backend"], "all_reduce": g["all_reduce"]}
                for g in (g0, g1)],
        abort_method=distributed.last_abort_method,
        nccl_async_error_handling=os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING"),
        memory_allocated_first_step=mem, flagged=int(result["mask"].sum()),
        restart_wall_s={"raise_to_first_step": restart_s, "abort": a1 - a0,
                        "health_check": h1 - h0, "reinit": r1 - r0,
                        "other": restart_s - (a1 - a0) - (h1 - h0) - (r1 - r0)},
    )


def restart_path(smoke, rows, names, main_mask, built_faults):
    """Phase 12: in-process restart on the card (see the module's docstring)."""
    from tpu_resiliency_torch.ops import scoring_kernels as sk

    sk.reset_launches()
    fields = restart_in_process(smoke, rows, names, main_mask)
    loop_launches = sk.fused_median_weights.launches_by_mode["loop"]

    # (b) Device hang: two ranks on the one card, no process group between them.
    hang_kw = dict(RESTART_WRAPPER_KW, **HANG_TIMEOUTS)
    store_port = free_port()
    (rc0, _, out0, err0), (rc1, (_, exit1), out1, err1) = run_children(
        [(HANG_CHILD, [r, store_port, json.dumps(hang_kw)]) for r in (0, 1)], timeout=180.0)
    if rc1 == 0 or "RESULT" in out1 or "PING" not in out1 or "SPIN" not in out1:
        raise AssertionError(f"the hung rank was not killed (rc {rc1}): {out1} {err1}")
    survivor = out0.get("RESULT", [{}])[0]
    if rc0 != 0 or survivor.get("result") != {"iteration": 1, "world": 1}:
        raise AssertionError(f"the survivor did not finish at world 1 (rc {rc0}): {out0} {err0}")
    parked = survivor["parked"]
    hang_to_kill = exit1 - out1["PING"][-1]["t"]
    kill_window = (HANG_TIMEOUTS["hard_timeout"] - RESTART_WRAPPER_KW["heartbeat_interval"],
                   HANG_TIMEOUTS["hard_timeout"] + 1.0)
    if not kill_window[0] <= hang_to_kill <= kill_window[1]:
        raise AssertionError(f"the hung rank died {hang_to_kill:.3f} s after its last ping, "
                             f"outside {kill_window}")

    # After the kill, three fresh interpreters together: (c) a fresh process must reach
    # the card (the spinning context died with its process), timed from its launch to
    # its first synchronize, which is what a process restart pays at the least; the
    # device error, one rank, a real sticky error (it stays within its own context);
    # (d) one rank whose collective times out for real under the Wrapper.
    error_kw = dict(RESTART_WRAPPER_KW, soft_timeout=10.0, hard_timeout=30.0,
                    heartbeat_timeout=10.0, barrier_timeout=30.0, completion_timeout=30.0)
    timeout_kw = {"wrapper": TIMEOUT_WRAPPER_KW, "group_timeout_s": NCCL_GROUP_TIMEOUT_S,
                  "busy_s": NCCL_BUSY_S}
    (fresh_rc, (fresh_start, _), fresh, fresh_err), (erc, _, eout, eerr), \
        (trc, _, tout, terr) = run_children(
            [(FRESH_CHILD, []), (ERROR_CHILD, [free_port(), json.dumps(error_kw)]),
             (TIMEOUT_CHILD, [free_port(), json.dumps(timeout_kw)])],
            timeout=TIMEOUT_WRAPPER_KW["barrier_timeout"] + 60.0)
    if fresh_rc != 0 or fresh.get("RESULT", [{}])[0].get("sum") != 2048.0:
        raise AssertionError(f"a fresh process could not use the card: {fresh} {fresh_err}")
    fresh_to_card = fresh["RESULT"][0]["t"] - fresh_start
    restart_s = fields["restart_wall_s"]["raise_to_first_step"]
    if restart_s >= fresh_to_card:
        raise AssertionError(f"the in-process restart took {restart_s:.3f} s, no faster than a "
                             f"fresh interpreter's {fresh_to_card:.3f} s to the card")
    if erc != 0 or "RESULT" not in eout:
        raise AssertionError(f"the device-error child failed (rc {erc}): {eerr}")
    err = eout["RESULT"][0]
    if not (err["probe_before"] and err["probe_after"] is False
            and err["health_check"].startswith("HealthCheckError")
            and err["outcome"] == "health_excluded" and err["attempts"] == [0]):
        raise AssertionError(f"the trapped rank was not excluded as the reference's: {err}")
    if trc != 0 or "RESULT" not in tout:
        raise AssertionError(f"the NCCL-timeout child failed (rc {trc}): {tout} {terr}")
    nccl_timeout = tout["RESULT"][0]
    got = nccl_timeout["result"]
    if got != {"iteration": 1, "all_reduce": [3.0] * 4, "backend": "nccl",
               "group_left_open": [False, False]}:
        raise AssertionError(f"the rank whose collective timed out did not restart into a new "
                             f"NCCL group: {nccl_timeout}")
    timeout_restart = nccl_timeout["restart_wall_s"]["raise_to_first_step"]
    if timeout_restart >= TIMEOUT_WRAPPER_KW["barrier_timeout"]:
        raise AssertionError(f"the restart after a NCCL timeout took {timeout_restart:.3f} s, "
                             f"past the Wrapper's barrier timeout")

    killed = reap_strays(timeout=30.0)
    smoke.emit(
        "restart_path", **fields, fresh_interpreter_to_card_s=fresh_to_card,
        stray_processes_killed=len(killed),
        device_hang={"survivor": survivor["result"], "hung_rank_returncode": rc1,
                     "last_ping_to_kill_s": hang_to_kill, "limit_s": kill_window,
                     "soft_timeout_s": HANG_TIMEOUTS["soft_timeout"],
                     "hard_timeout_s": HANG_TIMEOUTS["hard_timeout"],
                     "survivor_launches_while_peer_spun": parked["launches"],
                     "survivor_max_launch_ms": parked["max_ms"],
                     "spin_launches": out1["SPIN"][0]["launches"],
                     "fresh_process_after_kill": fresh["RESULT"][0]["sum"]},
        device_error=err,
        nccl_timeout=dict(nccl_timeout, group_timeout_s=NCCL_GROUP_TIMEOUT_S,
                          busy_s=NCCL_BUSY_S, limit_s=TIMEOUT_WRAPPER_KW["barrier_timeout"]),
        fault_kernels={"source": "tpu_resiliency_torch/csrc/faults.cu",
                       "build_seconds": built_faults.build_seconds,
                       "ptxas": list(built_faults.ptxas)},
    )
    return loop_launches


CKPT_SAVES = (1, 2, 3)  # checkpoint_path (a): iterations, one optimizer step apart
CKPT_CALLBACK_STEPS, CKPT_CALLBACK_EVERY = 4, 2  # checkpoint_path (c)
CKPT_STATE_F32_BYTES = 6_022_695_936  # the 1/16 shard's parameters, mu and nu
CKPT_SHARD_32_BYTES = 3_011_347_968  # each rank's state in checkpoint_path (b)
#: checkpoint_path (b): one rank of a two-rank job on the one card, a fresh interpreter.
#: argv: rank, store port, generation, "save" or "load", root, device, shard (JSON).
CKPT_CHILD = """
import json, sys, time

rank, port, gen, mode, root = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
import torch

import chip_smoke as cs
from tpu_resiliency_torch.checkpoint.comm import PeerExchange, StoreComm
from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
from tpu_resiliency_torch.checkpoint.replication import CliqueReplicationStrategy
from tpu_resiliency_torch.checkpoint.reshard import TreeLayout
from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
from tpu_resiliency_torch.platform.store import CoordStore

dev = torch.device(sys.argv[6])
state = cs.ckpt_state(torch, cs.llama_shard_shapes(**json.loads(sys.argv[7])), seed=1000 + rank,
                      device=dev, bf16=False)
stores = [CoordStore("127.0.0.1", port, timeout=120.0) for _ in range(2)]
comm = StoreComm(stores[0], rank, [0, 1], timeout=300.0, generation=gen)
ex = PeerExchange(stores[1], rank, timeout=300.0)
ex.start()
mgr = LocalCheckpointManager(root, rank=rank, comm=comm,
                             replication=CliqueReplicationStrategy(comm, ex, 1, 2))
out = {"rank": rank, "state_bytes": cs.ckpt_nbytes(state)}
if mode == "save":
    layout = TreeLayout.for_local_tree(state, cs.ckpt_specs(state), {"dp": 2}, [0, 1])
    cs.synchronize(torch, dev)
    t0 = time.perf_counter()
    mgr.save(1, PyTreeStateDict(state), is_async=True, layout=layout)
    out["foreground_ms"] = (time.perf_counter() - t0) * 1e3
    cs.ckpt_step(torch, state, seed=1)  # updated in place right after the save
    mgr.maybe_finalize(blocking=True)
    out["save_to_finalized_s"] = time.perf_counter() - t0
    out["staging"] = mgr.staging.stats()
else:
    t0 = time.perf_counter()
    tree, meta = mgr.load_tree(device=dev)
    cs.synchronize(torch, dev)
    out["load_s"] = time.perf_counter() - t0
    cs.ckpt_assert_equal(torch, tree, cs.ckpt_leaves(state), f"rank {rank}'s restore")
    out.update(iteration=meta["iteration"], equal=True, device=sorted(
        {str(t.device) for t in cs.ckpt_leaves(tree)}))
out["held"] = sorted([i.iteration, i.owner] for i in mgr.local_ids())
mgr.close()
ex.close()
for s in stores:
    s.close()
print("RESULT " + json.dumps(out), flush=True)
"""


def synchronize(torch, device):
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ckpt_specs(state):
    """The partition spec tree of a state sharded along every leaf's leading axis over
    ``dp`` (``None`` at the step counter)."""
    if isinstance(state, dict):
        return {k: ckpt_specs(v) for k, v in state.items()}
    return ("dp",) if hasattr(state, "data_ptr") else None


def host_memory_available() -> int:
    """``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def pinned_block(nbytes: int) -> int:
    """The bytes torch's caching host allocator pins for a buffer of ``nbytes``
    (the next power of two)."""
    return 1 << (nbytes - 1).bit_length()


def checkpoint_path(smoke):
    """Phase 13: local and async checkpointing on the card (see the module's docstring)."""
    import os
    import shutil
    import tempfile

    from tpu_resiliency_torch.checkpoint.local_manager import LocalCheckpointManager
    from tpu_resiliency_torch.checkpoint.state_dict import PyTreeStateDict
    from tpu_resiliency_torch.integrations import (
        HierarchicalCheckpointCallback,
        LoopContext,
        run_training,
    )
    from tpu_resiliency_torch.ops import scoring_kernels as sk
    from tpu_resiliency_torch.platform.store import KVServer
    from tpu_resiliency_torch.utils import events

    torch = smoke.torch
    dev = torch.device("cuda")
    empty_host_cache = getattr(torch._C, "_host_emptyCache", lambda: None)
    sk.reset_launches()
    state = ckpt_state(torch, llama_shard_shapes(**SHARD_16), seed=16, device=dev)
    nbytes = ckpt_nbytes(state)
    f32 = sum(t.numel() * 4 for t in ckpt_leaves(state) if t.dtype == torch.float32)
    if f32 != CKPT_STATE_F32_BYTES:
        raise AssertionError(f"the 1/16 shard holds {f32} B of f32 state, not "
                             f"{CKPT_STATE_F32_BYTES}")
    tmp = tempfile.mkdtemp(prefix="checkpoint-path-")
    # Held at once: (a)'s three check copies and two pinned staging leases, a
    # container loaded for the check; on disk: (a)'s three containers and the
    # blocking engine's.
    need_host = 4 * nbytes + 2 * pinned_block(nbytes)
    need_disk = 4 * nbytes
    free_host, free_disk = host_memory_available(), shutil.disk_usage(tmp).free
    print(f"checkpoint_path: {free_host} B of host memory available (needs {need_host}), "
          f"{free_disk} B free on the disk of {tmp} (needs {need_disk})", flush=True)
    if free_host < need_host or free_disk < need_disk:
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError(
            f"checkpoint_path needs {need_host} B of host memory and {need_disk} B of disk "
            f"in {tmp}; the machine has {free_host} B and {free_disk} B (the state is not "
            f"shrunk to fit)")
    timings = []

    def sink(e):
        if e.kind == "timing" and str(e.payload.get("name", "")).startswith("ckpt."):
            timings.append(dict(e.payload))

    def named(name, **match):
        return [t for t in timings if t["name"] == name
                and all(t.get(k) == v for k, v in match.items())]

    events.add_sink(sink)
    try:
        # The link's yardstick: one plain copy_ of the same bytes into one pinned buffer.
        leaves = ckpt_leaves(state)
        flat = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        views, off = [], 0
        for t in leaves:
            n = t.numel() * t.element_size()
            views.append(flat[off:off + n].view(t.dtype).view(t.shape))
            off += n
        plain_ms = []
        for _ in range(2):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for v, t in zip(views, leaves):
                v.copy_(t, non_blocking=True)
            b.record()
            b.synchronize()
            plain_ms.append(a.elapsed_time(b))
        del flat, views
        empty_host_cache()

        # (a) Three pipelined saves one optimizer step apart.
        mgr = LocalCheckpointManager(os.path.join(tmp, "pipelined"), rank=0, keep=3)
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        copies, fg_host, fg_device, started = {}, [], [], []
        for it in CKPT_SAVES:
            copies[it] = ckpt_host_copy(torch, state)  # for the check, outside the window
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            mgr.save(it, PyTreeStateDict(state), is_async=True)
            fg_host.append((time.perf_counter() - t0) * 1e3)
            b.record()
            started.append(t0)
            ckpt_step(torch, state, seed=it)  # every leaf updated in place right after
            fg_device.append((a, b))
        finalized = []
        deadline = time.monotonic() + 600.0
        while len(finalized) < len(CKPT_SAVES):
            done = mgr.maybe_finalize(blocking=False)
            finalized += [time.perf_counter()] * len(done)
            if time.monotonic() > deadline:
                raise AssertionError(f"checkpoint_path (a): {len(finalized)} of "
                                     f"{len(CKPT_SAVES)} saves finalized in 600 s")
            time.sleep(0.002)
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        peak_extra = torch.cuda.max_memory_allocated() - mem_before
        snapshot_ms = [a.elapsed_time(b) for a, b in fg_device]
        staging = mgr.staging.stats()
        if abs(mem_after - mem_before) > 1 << 20:
            raise AssertionError(f"checkpoint_path (a): device memory {mem_before} B before "
                                 f"the saves, {mem_after} B after finalize")
        if staging["hits"] < 1 or staging["misses"] > 2:
            raise AssertionError(f"checkpoint_path (a): staging pool {staging}")
        load_s = []
        for it in CKPT_SAVES:
            t0 = time.perf_counter()
            tree, meta = mgr.load_tree(it)
            torch.cuda.synchronize()
            load_s.append(time.perf_counter() - t0)
            ckpt_assert_equal(torch, tree, copies.pop(it), f"checkpoint_path (a) save {it}")
            if meta["iteration"] != it or tree["step"] != it - 1:
                raise AssertionError(f"checkpoint_path (a) save {it}: meta {meta}, step "
                                     f"{tree['step']}")
            del tree
        mgr.close()
        del mgr
        empty_host_cache()
        d2h = named("ckpt.save.d2h", engine="pipelined")
        stream = named("ckpt.save.stream", ok=True)

        # The blocking engine on the same state: copy_tensors_to_host, then the save.
        blocking = LocalCheckpointManager(os.path.join(tmp, "blocking"), rank=0,
                                          pipelined=False)
        copy = ckpt_host_copy(torch, state)
        timings.clear()
        t0 = time.perf_counter()
        blocking.save(len(CKPT_SAVES) + 1, PyTreeStateDict(state), is_async=True)
        blocking_fg = (time.perf_counter() - t0) * 1e3
        ckpt_step(torch, state, seed=len(CKPT_SAVES) + 1)
        blocking.maybe_finalize(blocking=True)
        blocking_e2e = time.perf_counter() - t0
        tree, _ = blocking.load_tree()
        ckpt_assert_equal(torch, tree, copy, "checkpoint_path (a) blocking engine")
        del tree, copy
        blocking_d2h = named("ckpt.save.d2h")
        blocking_write = named("ckpt.save.write", ok=True)
        blocking.close()
        del blocking
        shutil.rmtree(tmp)
        os.makedirs(tmp)
        empty_host_cache()
        fg_ratio = statistics.median(fg_host) / blocking_fg
        if fg_ratio > 0.25:
            raise AssertionError(f"checkpoint_path (a): the pipelined foreground window is "
                                 f"{fg_ratio:.4f} of the blocking engine's (limit 0.25)")
        card_bytes = nbytes  # every leaf lies on the card
        part_a = {
            "state_bytes": nbytes, "leaves": len(leaves), "saves": list(CKPT_SAVES),
            "foreground_ms": fg_host, "foreground_device_ms": snapshot_ms,
            "save_to_finalized_s": [f - s for f, s in zip(finalized, started)],
            "d2h_gbps": [t["bytes"] / t["duration_s"] / 1e9 for t in d2h],
            "d2h_ms": [t["duration_s"] * 1e3 for t in d2h],
            "plain_copy_ms": plain_ms, "plain_copy_gbps": [nbytes / ms / 1e6 for ms in plain_ms],
            "stream_gbps": [t["bytes"] / t["duration_s"] / 1e9 for t in stream],
            "staging": staging, "device_memory_before": mem_before,
            "device_memory_after": mem_after, "load_s": load_s,
            "snapshot_cost": {"design": "device clone on the current stream, D2H on a side "
                              "stream", "extra_device_bytes_per_save": card_bytes,
                              "peak_extra_device_bytes": peak_extra,
                              "next_step_delay_ms": snapshot_ms,
                              "design_a_would_stall_ms": min(plain_ms)},
            "blocking": {"foreground_ms": blocking_fg, "save_to_finalized_s": blocking_e2e,
                         "d2h_s": [t["duration_s"] for t in blocking_d2h],
                         "write_gbps": [t["bytes"] / t["duration_s"] / 1e9
                                        for t in blocking_write]},
            "foreground_ratio": fg_ratio,
        }

        # (b) Two ranks in fresh interpreters, clique replication over the store, rank
        # 1's disk wiped and restored from rank 0's mirror, then a one-rank reshard.
        server = KVServer(host="127.0.0.1", port=0)
        root = os.path.join(tmp, "clique")
        try:
            saved = run_children([(CKPT_CHILD, [r, server.port, 0, "save", root, "cuda",
                                                json.dumps(SHARD_32)]) for r in (0, 1)],
                                 timeout=600.0)
            shutil.rmtree(os.path.join(root, "s0", "r1"))
            loaded = run_children([(CKPT_CHILD, [r, server.port, 1, "load", root, "cuda",
                                                 json.dumps(SHARD_32)]) for r in (0, 1)],
                                  timeout=600.0)
        finally:
            server.close()
        for label, outs in (("save", saved), ("load", loaded)):
            for rc, _, out, err in outs:
                if rc != 0 or "RESULT" not in out:
                    raise AssertionError(f"checkpoint_path (b) {label}: a rank failed (rc {rc}):"
                                         f" {out} {err}")
        saved = [o[2]["RESULT"][0] for o in saved]
        loaded = [o[2]["RESULT"][0] for o in loaded]
        if any(s["state_bytes"] != CKPT_SHARD_32_BYTES for s in saved):
            raise AssertionError(f"checkpoint_path (b): rank states {saved}")
        if not all(r["equal"] and r["device"] == ["cuda:0"] and r["iteration"] == 1
                   for r in loaded):
            raise AssertionError(f"checkpoint_path (b): restores {loaded}")
        left = reap_strays(timeout=30.0)
        if left:
            raise AssertionError(f"checkpoint_path (b): processes left over: {left}")
        ranks = [ckpt_state(torch, llama_shard_shapes(**SHARD_32), seed=1000 + r, device=dev,
                            bf16=False) for r in (0, 1)]
        reshard = LocalCheckpointManager(root, rank=0, comm=None)
        t0 = time.perf_counter()
        tree, meta = reshard.load_resharded_tree(device=dev)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        reshard.close()
        joined = [torch.cat(pair) for pair in zip(*(ckpt_leaves(s) for s in ranks))]
        ckpt_assert_equal(torch, tree, joined, "checkpoint_path (b) reshard to one rank")
        if meta["layout"]["ranks"] != [0]:
            raise AssertionError(f"checkpoint_path (b): resharded onto {meta['layout']}")
        part_b = {"ranks": saved, "restores": loaded, "reshard_s": reshard_s,
                  "reshard_bytes": sum(t.numel() * t.element_size() for t in joined),
                  "stray_processes_left": len(left)}
        del tree, joined, ranks
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        empty_host_cache()

        # (c) The callback: the local tier every 2 steps, async, 4 steps of in-place updates.
        mgr = LocalCheckpointManager(os.path.join(tmp, "callback"), rank=0)
        cb = HierarchicalCheckpointCallback(local_manager=mgr, local_every=CKPT_CALLBACK_EVERY)
        step0 = state["step"]
        t0 = time.perf_counter()
        run_training(lambda s, i: ckpt_step(torch, s, seed=100 + i) or s, state,
                     CKPT_CALLBACK_STEPS, callbacks=[cb])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        at_last = ckpt_host_copy(torch, state)
        ckpt_step(torch, state, seed=999)  # the live state moves on
        fresh = LoopContext()
        t0 = time.perf_counter()
        if not cb.restore_latest(fresh):
            raise AssertionError("checkpoint_path (c): nothing to restore")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ckpt_assert_equal(torch, fresh.state, at_last, "checkpoint_path (c) callback restore")
        if fresh.start_step != CKPT_CALLBACK_STEPS or not all(
                t.is_cuda for t in ckpt_leaves(fresh.state)):
            raise AssertionError(f"checkpoint_path (c): restored step {fresh.start_step}")
        part_c = {"steps": CKPT_CALLBACK_STEPS, "local_every": CKPT_CALLBACK_EVERY,
                  "train_s": train_s, "restore_s": restore_s, "restored_step": fresh.start_step,
                  "state_step": [step0, fresh.state["step"]], "staging": mgr.staging.stats()}
        cb.close()
        del fresh, at_last
    finally:
        events.remove_sink(sink)
        shutil.rmtree(tmp, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    empty_host_cache()
    smoke.emit("checkpoint_path", host_memory_available=free_host, free_disk=free_disk,
               tmp=tmp, needs={"host": need_host, "disk": need_disk},
               median_kernel_launches=dict(sk.fused_median_weights.launches_by_mode),
               pipelined=part_a, clique=part_b, callback=part_c)


INJOB_STEPS, INJOB_FAULT_STEP, INJOB_CKPT_EVERY = 300, 150, 100  # injob_path (a), (b)
INJOB_HB_TIMEOUT_S, INJOB_CHECK_INTERVAL_S = 5.0, 0.5  # the monitor's heartbeat settings
INJOB_TERM_GRACE_S = 15.0  # the agent's term_grace: a killed worker must be gone by then
LAYERED_STEPS, LAYERED_FAIL_STEP = 200, 150  # injob_path (c)
#: The launcher's flags in every injob_path scenario; the monitor kills at once on a
#: hang verdict (no stack-dump grace), so hang to kill is held to the timeout's window.
INJOB_LAUNCHER = ["--nproc-per-node", "1", "--monitor-interval", "0.1", "--rdzv-last-call",
                  "0.2", "--rdzv-endpoint", "127.0.0.1:0", "--max-restarts", "1"]
INJOB_FT = ["--ft-param-rank_heartbeat_timeout", str(INJOB_HB_TIMEOUT_S),
            "--ft-param-workload_check_interval", str(INJOB_CHECK_INTERVAL_S),
            "--ft-param-stack_dump_grace", "0"]


def card_pids() -> dict[int, int]:
    """``{pid: used MiB}`` of the processes ``nvidia-smi`` lists on the card (none
    where there is no ``nvidia-smi``, as in a CPU rehearsal)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
    except FileNotFoundError:
        return {}
    pids = {}
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit():
            pids[int(pid)] = int(mib.strip()) if mib.strip().isdigit() else 0
    return pids


def holds_card(pid: int) -> bool:
    """Whether ``pid`` has a card's device file open (``/dev/nvidia<N>``: a CUDA
    context; the control and UVM files alone are not one)."""
    try:
        fds = Path(f"/proc/{pid}/fd")
        for fd in fds.iterdir():
            target = str(fd.readlink())
            if target.startswith("/dev/nvidia") and target[len("/dev/nvidia"):].isdigit():
                return True
    except OSError:
        pass
    return False


class CardWatch:
    """Samples, on a thread, every process this run started (``stray_processes``):
    its command line, when it was first and last seen, when it held the card (a
    ``/dev/nvidia<N>`` open), and ``nvidia-smi``'s pids and their MiB (every other
    sample, as that call is slower); and the card's used bytes (``used_bytes``)."""

    def __init__(self, interval: float = 0.2, used_bytes=None):
        import threading

        self.interval = interval
        self.used_bytes = used_bytes  # () -> the card's used bytes, sampled each tick
        self.memory: list[tuple[float, int]] = []
        self.seen: dict[int, dict] = {}
        self.smi_lists_pids = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="card-watch", daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(30)

    def _note(self, pid, now, **flags):
        s = self.seen.setdefault(pid, {"first": now, "last": now, "card_first": None,
                                       "card_last": None, "smi_first": None,
                                       "smi_last": None, "mib": 0, "cmdline": ""})
        s["last"] = now
        if not s["cmdline"]:
            try:
                s["cmdline"] = Path(f"/proc/{pid}/cmdline").read_bytes().replace(
                    b"\0", b" ").decode(errors="replace")
                s["ppid"] = int(Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                pass
        for key in ("card", "smi"):
            if flags.get(key):
                s[f"{key}_first"] = s[f"{key}_first"] or now
                s[f"{key}_last"] = now
        s["mib"] = max(s["mib"], flags.get("mib", 0))

    def _run(self):
        import os

        tick = 0
        while not self._stop.is_set():
            now = time.time()
            if self.used_bytes is not None:
                self.memory.append((now, self.used_bytes()))
            for pid in stray_processes():
                self._note(pid, now, card=holds_card(pid))
            if tick % 2 == 0:
                listed = card_pids()
                now = time.time()
                self.smi_lists_pids |= os.getpid() in listed
                for pid, mib in listed.items():
                    if pid in self.seen or pid == os.getpid():
                        self._note(pid, now, smi=True, mib=mib)
            tick += 1
            self._stop.wait(self.interval)


def run_launcher(tag, root, launcher_args, worker_argv, timeout):
    """One fresh process tree: the port's launcher as a subprocess (its own session),
    stdout and stderr to files, watched by a :class:`CardWatch`. Returns its return
    code, events, output, the watch and the launcher's pid. Every process it started
    is reaped afterwards."""
    import os
    import signal

    here = Path(__file__).resolve().parent
    events = root / f"{tag}.events.jsonl"
    out_path, err_path = root / f"{tag}.out", root / f"{tag}.err"
    env = dict(os.environ, PYTHONPATH=str(here), TPU_RESILIENCY_LOG_LEVEL="INFO")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "TPU_RESILIENCY_STORE_PORT",
              "TPU_RESILIENCY_STORE_HOST", "CUDA_VISIBLE_DEVICES"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "tpu_resiliency_torch.launcher.launch", *launcher_args,
           "--events-file", str(events), "--run-dir", str(root / f"{tag}.run"), *worker_argv]
    used = None
    if "torch" in sys.modules and sys.modules["torch"].cuda.is_initialized():
        torch = sys.modules["torch"]

        def used():
            free, total = torch.cuda.mem_get_info()
            return total - free

    watch = CardWatch(used_bytes=used).start()
    t0 = time.time()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        p = subprocess.Popen(cmd, stdout=out, stderr=err, env=env, cwd=here,
                             start_new_session=True)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            rc = "timeout"
    seconds = time.time() - t0
    killed = reap_strays(timeout=10.0)
    watch.stop()
    recs = [json.loads(ln) for ln in events.read_text().splitlines()] if events.exists() else []
    return {"rc": rc, "events": recs, "out": out_path.read_text(), "err": err_path.read_text(),
            "watch": watch, "agent": p.pid, "seconds": seconds, "strays_killed": len(killed)}


def results_of(run) -> list[dict]:
    return [json.loads(ln[len("RESULT "):]) for ln in run["out"].splitlines()
            if ln.startswith("RESULT ")]


def first(recs, kind, **match):
    for e in recs:
        if e.get("kind") == kind and all(e.get(k) == v for k, v in match.items()):
            return e
    raise AssertionError(f"no {kind} event {match or ''} in the run's stream")


def card_holders(run, worker_pids, promoted=None) -> dict:
    """Which processes of ``run`` held a CUDA context, by role: those ``nvidia-smi``
    listed where it lists this run's pids, else those with a ``/dev/nvidia<N>`` open.
    Fails if any but a worker did, or if ``promoted`` (a spare's pid and the time of its
    promotion) did before its promotion.
    Processes with the device files open but no context are reported beside."""
    watch, agent = run["watch"], run["agent"]
    key = "smi" if watch.smi_lists_pids else "card"
    roles = {}
    for pid, s in watch.seen.items():
        if pid in worker_pids:
            role = "worker"
        elif pid == agent:
            role = "agent"
        elif "tpu_resiliency_torch.launcher.park" in s["cmdline"]:
            role = "spare"
        elif "tpu_resiliency_torch.launcher.launch" in s["cmdline"]:
            role = "monitor" if s.get("ppid") == agent else "launcher"
        elif "tpu_resiliency_torch.examples" in s["cmdline"]:
            role = "wrapper_monitor"  # forked from a worker: a worker's cmdline, no card
        else:
            role = "other"
        roles[pid] = role
        held = s[f"{key}_first"]
        detail = (f"{role} pid {pid} ({s['cmdline'][:100]}): first seen {s['first']:.3f}, "
                  f"context (nvidia-smi) from {s['smi_first']}, device files from "
                  f"{s['card_first']}, promoted {promoted}")
        if role == "wrapper_monitor" and held is not None and held == s["card_first"]:
            # A fork of a worker that holds a context inherits its device files, and
            # the daemonized monitor closes every inherited descriptor at once: a
            # sample may catch them, but no context, and only in that first moment.
            if s["card_last"] - s["card_first"] > 1.0:
                raise AssertionError(f"a Wrapper monitor kept its worker's device files: "
                                     f"{detail}, until {s['card_last']:.3f}")
        elif held is not None and role != "worker":
            raise AssertionError(f"a process other than a worker held the card: {detail}")
        if held is not None and promoted and pid == promoted[0] and held < promoted[1]:
            raise AssertionError(f"a spare held the card before its promotion: {detail}")
    counts = {}
    for role in roles.values():
        counts[role] = counts.get(role, 0) + 1
    return {"processes_by_role": counts,
            "other_processes": sorted({watch.seen[p]["cmdline"][:100] for p, r in roles.items()
                                       if r == "other"}),
            "context_holders_by": "nvidia-smi" if key == "smi" else "device files",
            "context_holders": sorted(f"{roles[p]} {p}" for p, s in watch.seen.items()
                                      if s[f"{key}_first"] is not None
                                      and roles[p] != "wrapper_monitor"),
            "device_files_open_s": {f"{roles[p]} {p}": s["card_last"] - s["card_first"]
                                    for p, s in watch.seen.items() if s["card_first"]},
            "nvidia_smi_lists_pids": watch.smi_lists_pids}


def released_memory(memory, kill, until) -> dict:
    """The card memory a killed worker held and how long after the kill it was given
    back, from the card's used bytes sampled between the kill and ``until`` (the
    next worker's imports, before its context): the drop from the last sample before
    the kill to the lowest after it, and the first sample within 64 MiB of that low."""
    before = [used for t, used in memory if t <= kill]
    after = [(t, used) for t, used in memory if kill < t <= until]
    if not before or not after:
        return {"dead_worker_card_bytes": "not measured",
                "kill_to_card_memory_released_s": "not measured"}
    low = min(used for _, used in after)
    released = next(t for t, used in after if used <= low + (64 << 20))
    return {"dead_worker_card_bytes": before[-1] - low,
            "kill_to_card_memory_released_s": released - kill}


def restart_segments(recs, dead_pid, new_pid, last_hb) -> dict:
    """The restart of ``dead_pid`` by ``new_pid``, cut from the run's event stream,
    in seconds."""
    stage = {e["stage"]: e["t"] for e in recs
             if e.get("kind") == "worker_stage" and e.get("pid") == new_pid}
    detected = first(recs, "hang_detected", p_pid=dead_pid)["ts"]
    killed = first(recs, "kill_ladder", p_pid=dead_pid, step="SIGKILL")["ts"]
    failed = first(recs, "failure_detected", round=0)["ts"]
    requested = first(recs, "restart_requested", round=0)["ts"]
    placed = first(recs, "rendezvous_round", round=1)["ts"]
    seg = {
        "detect": detected - last_hb,
        "kill_signal": killed - detected,
        "death": failed - killed,  # the killed process's exit, as the agent's poll sees it
        "teardown": requested - failed,
        "rendezvous": placed - requested,
        "spawn_and_startup": stage["imports"] - placed,
        "cuda_context_and_kernel_load": stage["device"] - stage["imports"],
        "restore": stage["restored"] - stage["device"],
        "first_step": stage["first_step"] - stage["restored"],
    }
    promoted = [e for e in recs if e.get("kind") == "worker_promoted" and e.get("round") == 1]
    seg["spawn_and_startup_split"] = {
        "to_promotion": (promoted[0]["ts"] - placed) if promoted else "not promoted",
        "interpreter_and_package_import": stage["entry"] - placed,
        "example_imports": stage["imports"] - stage["entry"],
    }
    seg["total_last_heartbeat_to_first_step"] = stage["first_step"] - last_hb
    return seg


def shard_nbytes(shapes) -> int:
    """Bytes of a tree of f32 leaf shapes."""
    if isinstance(shapes, dict):
        return sum(shard_nbytes(v) for v in shapes.values())
    return 4 * int(np.prod(shapes))


def hang_scenario(tag, root, shard_shapes, extra_launcher=(), worker_extra=(), kill_slack_s=1.0):
    """injob_path (a) and (b): the resilient-training example at config 4 with the
    1/32 Llama shard, a device hang in round 0, a respawn that resumes from step 100.
    ``worker_extra``: worker flags that override these (a CPU rehearsal's device and
    widths); ``kill_slack_s``: how long past its next check the monitor may take to
    kill (a CPU rehearsal shares its cores with other work)."""
    import shutil

    worker = ["-m", "tpu_resiliency_torch.examples.resilient_training",
              "--steps", str(INJOB_STEPS), "--report-every", str(REPORT_INTERVAL),
              "--ckpt-every", str(INJOB_CKPT_EVERY), "--fault", "hang",
              "--fault-step", str(INJOB_FAULT_STEP), "--ranks", str(R), "--signals", str(S),
              "--window", str(W), "--ckpt-dir", str(root / f"{tag}.ckpt"), "--verify",
              "--shard-shapes", json.dumps(shard_shapes), *worker_extra]
    run = run_launcher(tag, root, [*INJOB_LAUNCHER, *INJOB_FT, *extra_launcher], worker,
                       timeout=240.0)
    shutil.rmtree(root / f"{tag}.ckpt", ignore_errors=True)
    recs = run["events"]
    rounds = sorted({e["round"] for e in recs if e.get("kind") == "rendezvous_round"})
    if run["rc"] != 0 or rounds != [0, 1]:
        raise AssertionError(f"injob {tag}: rc {run['rc']}, rounds {rounds}:\n"
                             f"{run['err'][-4000:]}")
    fault = first(recs, "fault")
    dead = fault["pid"]
    hang = first(recs, "hang_detected", p_pid=dead)
    if hang.get("via") != "heartbeat":
        raise AssertionError(f"injob {tag}: the hang was detected via {hang.get('via')}")
    last_hb = hang["ts"] - hang["blocked_s"]
    kill = first(recs, "kill_ladder", p_pid=dead, step="SIGKILL")["ts"]
    death = first(recs, "failure_detected", round=0)["ts"]
    hang_to_kill = kill - last_hb
    window = (INJOB_HB_TIMEOUT_S, INJOB_HB_TIMEOUT_S + INJOB_CHECK_INTERVAL_S + kill_slack_s)
    if not window[0] <= hang_to_kill <= window[1]:
        raise AssertionError(f"injob {tag}: last heartbeat to the kill {hang_to_kill:.3f} s, "
                             f"outside {window}")
    if death - kill > INJOB_TERM_GRACE_S:
        raise AssertionError(f"injob {tag}: the killed worker lived {death - kill:.3f} s on")
    (res,) = results_of(run)
    new_pid = [e["pid"] for e in recs if e.get("kind") == "worker_stage"
               and e.get("stage") == "restored"][0]
    checks = {"restored_equal": True, "masks_equal_uninterrupted": True,
              "slow_ranks_flagged": True, "nvcc_runs": 0, "start_step": INJOB_CKPT_EVERY,
              "final_step": INJOB_STEPS}
    bad = {k: res.get(k) for k, v in checks.items() if res.get(k) != v}
    if bad or res.get("restored_bytes", 0) < shard_nbytes(shard_shapes):
        raise AssertionError(f"injob {tag}: round 1 {bad}, restored {res.get('restored_bytes')} "
                             f"B: {res}")
    round0_loop = max(e["loop_launches"] for e in recs
                      if e.get("kind") == "report" and e.get("pid") == dead)
    on_card = "cpu" not in worker_extra  # a CPU rehearsal launches no kernel
    if on_card and (round0_loop < 1 or res["launches"]["loop"] < 1):
        raise AssertionError(f"injob {tag}: loop launches {round0_loop} and {res['launches']}")
    promoted = [e for e in recs if e.get("kind") == "worker_promoted" and e.get("round") == 1]
    holders = card_holders(run, {dead, new_pid},
                           promoted=(new_pid, promoted[0]["ts"]) if promoted else None)
    seen = run["watch"].seen
    dead_seen = seen.get(dead, {})
    new_stages = {e["stage"]: e["t"] for e in recs
                  if e.get("kind") == "worker_stage" and e.get("pid") == new_pid}
    freed = released_memory(run["watch"].memory, kill, new_stages["imports"])
    round0_first = [e["seconds"] for e in recs if e.get("kind") == "worker_stage"
                    and e.get("stage") == "first_step" and e.get("pid") == dead]
    fields = {
        "returncode": run["rc"], "rounds": rounds, "seconds": run["seconds"],
        "hang_step": fault["step"], "checkpoint_at_hang": fault["checkpoint"],
        "last_heartbeat_to_kill_s": hang_to_kill, "limit_s": window,
        "kill_to_death_s": death - kill, "last_heartbeat_to_death_s": death - last_hb,
        "segments_s": restart_segments(recs, dead, new_pid, last_hb),
        "dead_worker_card_mib_by_nvidia_smi": dead_seen.get("mib") or "not measured",
        "kill_to_pid_off_nvidia_smi_s": (dead_seen["smi_last"] - kill)
        if dead_seen.get("smi_last") else "not measured",
        "kill_to_device_files_closed_s": (dead_seen["card_last"] - kill)
        if dead_seen.get("card_last") else "not measured",
        **freed,
        "round0_first_step_ms": round0_first[0] * 1e3 if round0_first else "not measured",
        "round1": {k: res[k] for k in ("start_step", "final_step", "restored_equal",
                                       "restored_bytes", "masks_equal_uninterrupted",
                                       "nvcc_runs", "first_step_ms", "step_ms_median")},
        "ranks_flagged_per_report": {k: len(v) for k, v in res["masks"].items()},
        "loop_launches": {"round0": round0_loop, "round1": res["launches"]["loop"]},
        "promoted": bool(promoted), **holders, "strays_killed": run["strays_killed"],
    }
    return fields, round0_loop + res["launches"]["loop"], res["masks"]


def layered_scenario(root, masks, worker_extra=()):
    """injob_path (c): a sticky device error under the Wrapper; the health check fails,
    the process exits and the launcher's respawn completes in a new context."""
    worker = ["-m", "tpu_resiliency_torch.examples.layered_restart", "--fault", "device-error",
              "--fault-rank", "0", "--steps", str(LAYERED_STEPS), "--fail-step",
              str(LAYERED_FAIL_STEP), "--report-every", str(REPORT_INTERVAL), "--ranks", str(R),
              "--signals", str(S), "--window", str(W), *worker_extra]
    run = run_launcher("layered", root, [*INJOB_LAUNCHER, "--no-ft-monitors"], worker,
                       timeout=180.0)
    recs = run["events"]
    rounds = sorted({e["round"] for e in recs if e.get("kind") == "rendezvous_round"})
    if run["rc"] != 0 or rounds != [0, 1]:
        raise AssertionError(f"injob layered: rc {run['rc']}, rounds {rounds}:\n"
                             f"{run['err'][-4000:]}")
    failed = first(recs, "worker_failed", round=0)
    log = run["out"] + run["err"]
    if "HealthCheckError" not in failed.get("detail", ""):
        raise AssertionError(f"injob layered: round 0 did not end in HealthCheckError: {failed}")
    layers = {name: f"[NestedRestarter] name=[{name}]" in log for name in ("InJob", "InProcess")}
    (res,) = results_of(run)
    if not all(layers.values()) or res["round"] != 1 or res["iterations"] != [0]:
        raise AssertionError(f"injob layered: layers {layers}, round 1 {res}")
    on_card = "cpu" not in worker_extra  # a CPU rehearsal launches no kernel
    if res["flagged"] != masks[str(REPORT_INTERVAL)] or (on_card and res["launches"]["loop"] < 1):
        raise AssertionError(f"injob layered: round 1 flags {res['flagged']}, the uninterrupted "
                             f"run's step {REPORT_INTERVAL} {masks[str(REPORT_INTERVAL)]}")
    # The launcher's children; the Wrapper's monitor processes (double-forked from
    # them) run the same command line but must hold no card.
    worker_pids = {p for p, s in run["watch"].seen.items()
                   if s.get("ppid") == run["agent"] and "examples.layered_restart" in s["cmdline"]}
    holders = card_holders(run, worker_pids)
    res["ranks_flagged"] = len(res.pop("flagged"))
    return {"returncode": run["rc"], "rounds": rounds, "seconds": run["seconds"],
            "round0_failure": failed["detail"].splitlines()[0],
            "nested_restarter_layers": layers, "round1": res, **holders}, \
        res["launches"]["loop"]


def runtime_check_on_card(torch):
    """injob_path (d): ``CudaRuntimeCheck`` healthy; past a pressure threshold set just
    below the pressure an allocation makes; and with ``expect_devices`` one past the
    count."""
    from tpu_resiliency_torch.watchdog import CudaRuntimeCheck

    out = {"healthy": CudaRuntimeCheck()()}
    count = torch.cuda.device_count()
    check = CudaRuntimeCheck(expect_devices=count + 1)
    out["expect_devices_plus_one"] = (check(), check.last_failure)
    free, total = torch.cuda.mem_get_info(0)
    block = torch.empty(int(free * 0.5), dtype=torch.uint8, device="cuda:0")
    free_after, _ = torch.cuda.mem_get_info(0)
    pressure = 1.0 - free_after / total
    check = CudaRuntimeCheck(hbm_usage_threshold=pressure - 0.01)
    out["pressure"] = pressure
    out["below_pressure"] = (check(), check.last_failure)
    out["above_pressure"] = CudaRuntimeCheck(hbm_usage_threshold=pressure + 0.01)()
    del block
    torch.cuda.empty_cache()
    if not (out["healthy"] and out["above_pressure"] and out["expect_devices_plus_one"][0] is False
            and out["below_pressure"][0] is False):
        raise AssertionError(f"CudaRuntimeCheck on the card: {out}")
    return out


def injob_path(smoke):
    """Phase 14: fault tolerance and in-job restart on the card (see the module's
    docstring). Returns the workers' ``loop`` launches."""
    import shutil
    import tempfile

    torch = smoke.torch
    t0 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="injob-path-"))
    shapes = llama_shard_shapes(**SHARD_32)
    shard = {"params": shapes, "opt": {"mu": shapes, "nu": shapes}}
    if shard_nbytes(shard) != CKPT_SHARD_32_BYTES:
        raise AssertionError(f"the 1/32 shard holds {shard_nbytes(shard)} B, not "
                             f"{CKPT_SHARD_32_BYTES}")
    try:
        try:
            import yaml  # noqa: F401

            has_yaml = True
        except ImportError:
            has_yaml = False
        cold, cold_loop, masks = hang_scenario("cold", root, shard)
        warm, warm_loop, _ = hang_scenario("warm", root, shard, extra_launcher=[
            "--warm-spares", "1", "--warm-spare-warmup", "runtime"])
        if not warm["promoted"]:
            raise AssertionError("injob warm: round 1 was not promoted from the parked spare")
        layered, layered_loop = layered_scenario(root, masks)
        runtime = runtime_check_on_card(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    smoke.emit("injob_path", seconds=time.perf_counter() - t0, yaml_importable=has_yaml,
               ranks=R, signals=S, window=W, steps=INJOB_STEPS, hang_step=INJOB_FAULT_STEP,
               checkpoint_every=INJOB_CKPT_EVERY, shard_bytes=CKPT_SHARD_32_BYTES,
               heartbeat_timeout_s=INJOB_HB_TIMEOUT_S,
               workload_check_interval_s=INJOB_CHECK_INTERVAL_S,
               cold_respawn=cold, warm_spare_respawn=warm, layered_sticky_error=layered,
               cuda_runtime_check=runtime)
    return cold_loop + warm_loop + layered_loop


def main() -> int:
    import os

    if not os.environ.get(RUN_ENV):
        # Stamp the run and start over in its place (same pid), so that every
        # process the run starts, forked or spawned, holds the stamp in its
        # environment: that is how reap_strays tells this run's processes from others.
        import uuid

        os.execve(sys.executable, sys.orig_argv, dict(os.environ, **{RUN_ENV: uuid.uuid4().hex}))

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
    from tpu_resiliency_torch.inprocess.tools.inject_fault import FAULT_KERNELS

    t0 = time.perf_counter()
    _build.build([*sk.KERNEL_NAMES.values(), FAULT_KERNELS])
    built = {mode: _build.load(name) for mode, name in sk.KERNEL_NAMES.items()}
    built_faults = _build.load(FAULT_KERNELS)
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

    from tpu_resiliency_torch.telemetry.device_profiler import DeviceTimeProfiler

    def breakdown(label, mt, st, score_ms, kernel_functions, reports=5):
        """Device time by kernel over ``reports`` reports in one profiler session,
        opened as a ``DeviceTimeProfiler`` window opens (a synchronize, then its
        settle pause: the trace can lose a session's first records). The mode's
        kernel records must number its launches, or a record was lost."""
        mode = mt.kernel_mode
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(DeviceTimeProfiler.SETTLE_S)
            before = fused_median_weights.launches_by_mode[mode]
            for _ in range(reports):
                mt.score(st)
            torch.cuda.synchronize()
        launched = fused_median_weights.launches_by_mode[mode] - before
        rows_by_time, kernel_records = [], 0
        for evt in prof.key_averages():
            dev_us = getattr(evt, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "cuda_time_total", 0)
            if dev_us and evt.key and not evt.key.startswith("aten::"):
                rows_by_time.append((evt.key, dev_us / reports / 1e3, evt.count // reports))
                if any(f in evt.key for f in kernel_functions):
                    kernel_records += evt.count
        if not launched == kernel_records == reports:
            raise AssertionError(f"breakdown {label}: {kernel_records} {mode} kernel records, "
                                 f"{launched} launches, {reports} reports")
        rows_by_time.sort(key=lambda r: -r[1])
        busy_ms = sum(ms for _, ms, _ in rows_by_time)
        smoke.emit(
            "breakdown", path=label, reports=reports, kernel_mode=mode,
            kernel_records=kernel_records, kernel_launches=launched,
            device_busy_ms_per_report=busy_ms or "not measured",
            # share of the event-timed report (phase times) in which the card ran no kernel
            idle_share=1.0 - busy_ms / score_ms if busy_ms else "not measured",
            device_ms_per_report_by_kernel=[
                {"kernel": k[:80], "ms": ms, "launches": n} for k, ms, n in rows_by_time[:12]
            ] or "not measured",
        )

    breakdown("config4", mt_t, st, t4["score_ms_per_report"], LOOP_KERNEL_FUNCTIONS)
    breakdown("long_window", mt_lt, st_l, tl["score_ms_per_report"], RADIX_KERNEL_FUNCTIONS,
              reports=3)

    # 10. detector path; 11. group path; 12. restart path ------------------------
    del mt_t, st, mt_lt, st_l, long_ring
    torch.cuda.empty_cache()
    path_launches["loop"] += detector_path(smoke, rows, names, flagged(rep1, R))
    group_path(smoke, rows.permute(1, 2, 0), torch.full((R, S), W, dtype=torch.int32, device=dev),
               names)
    path_launches["loop"] += restart_path(smoke, rows, names, flagged(rep1, R), built_faults)

    # 13. checkpoint path ----------------------------------------------------------
    del rows
    torch.cuda.empty_cache()
    checkpoint_path(smoke)

    # 14. in-job restart path: the workers' own loop launches ------------------------
    torch.cuda.empty_cache()
    path_launches["loop"] += injob_path(smoke)

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
