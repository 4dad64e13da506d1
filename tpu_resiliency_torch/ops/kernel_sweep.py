"""Sweep the window-reduction kernels against the sort path on the card, and derive
the port's auto-selection defaults from the times.

Counterpart of ``scripts/bench_pallas_sweep.py``. For every window W and rank count R
of the grid (S = 64 signals, full windows of uniform timings), it times the ``loop``,
``pairwise`` and ``radix`` kernels and the sort path (``masked_median`` +
``masked_total``) on the telemetry ring's permuted ``[R, S, W]`` view, as
``MeshTelemetry.score`` hands it over. Each time is the median, over several calls,
of the device time of the kernels that one call launched (``torch.profiler``, as the
JAX sweep takes device time from its profiler), with the L2 cache flushed before each
call (a report finds the ring cold). Two results follow. A path "wins" a cell against
another unless it is slower by more than the TPU sweep's 2% (``TOL``):

- ``loop_max_window``: the largest W such that ``loop`` wins against ``radix`` and
  against the sort at every R, for it and every smaller W. It is the port's default
  cap (``scoring_kernels.DEFAULT_MAX_WINDOW``; override:
  ``$TPU_RESILIENCY_CUDA_MAX_WINDOW``).
- ``kernel_beats_sort_at``: per W, whether the better auto-selectable kernel
  (``loop`` or ``radix``) wins against the sort at every R; and
  ``radix_beats_sort_past_cap``, whether ``radix`` does at every W past the cap, which
  sets ``scoring_kernels.DEFAULT_RADIX_AUTO`` (override: ``$TPU_RESILIENCY_CUDA_RADIX``).

``pairwise`` is timed but never votes: it is never auto-selected.

Run on a CUDA card from the root of a checkout::

    python -m tpu_resiliency_torch.ops.kernel_sweep [--ws 32,64,128] [--rs 256,4096]

It prints one JSON object. ``chip_smoke.py`` runs it as its ``sweep`` phase.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from tpu_resiliency_torch.ops import scoring_kernels as sk
from tpu_resiliency_torch.telemetry.scoring import masked_median, masked_total

WINDOWS = (32, 64, 128, 256, 512, 1024)
RANKS = (256, 1024, 4096)
SIGNALS = 64
TOL = 1.02
PATHS = ("loop", "pairwise", "radix", "sort")
L2_FLUSH_BYTES = 64 << 20  # larger than the H100's 50 MB L2
TARGET_MS = 300.0  # timed work per cell and path, to choose its repetitions


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median ms of ``reps`` calls of ``fn``, each between its own CUDA events with
    the L2 cache flushed (``flush.zero_()``) before it. Three untimed calls first.

    The span holds the host's enqueue of the call: a launch shorter than it (about
    0.04 ms for the port's kernel wrappers) reads the enqueue. :func:`device_ms` reads
    the kernels alone; this times what users pay end to end, enqueue included."""
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


#: Name of the kernel ``torch.cuda._sleep`` launches. :func:`device_ms` opens each
#: timed call with two of them and closes it with one, so the trace shows where a
#: call begins and ends.
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
#: Profiler sessions :func:`device_ms` runs before it gives up on a trace, and the
#: pause after its untimed calls, before the timed ones.
SESSION_ATTEMPTS = 3
SESSION_SETTLE_S = 0.02


def median_call_ms(records, calls: int) -> float:
    """The median over timed calls of the summed duration of the device records of
    each call, in ms.

    ``records``: ``(name, start_us, duration_us)`` of every device record of the
    trace (kernels, copies, sets), in any order. In the order of their start, a call
    opens with two markers and closes with one; the L2 flush lies between one call's
    closing marker and the next call's opening pair, and is left out with the
    markers. A run of markers closes the open call if its length is odd and opens
    one if it is two or more, so a record the trace lost costs at most the call it
    belonged to, never a wrong sum: a call whose closing marker is missing is
    dropped when the next pair opens. Raises if fewer than half of ``calls`` calls
    are found, or more than ``calls`` (records of another session)."""
    recs = sorted(records, key=lambda rec: rec[1])
    per_call, total, i = [], None, 0
    while i < len(recs):
        if MARKER not in recs[i][0]:
            if total is not None:
                total += recs[i][2]
            i += 1
            continue
        run = 1
        while i + run < len(recs) and MARKER in recs[i + run][0]:
            run += 1
        if run % 2 and total is not None:
            per_call.append(total)
        total = 0.0 if run >= 2 else None
        i += run
    if 2 * len(per_call) < calls or not per_call or len(per_call) > calls:
        raise RuntimeError(
            f"the profiler trace shows {len(per_call)} of {calls} timed calls in "
            f"{len(recs)} device records: {[name[:40] for name, _, _ in recs[:24]]}"
        )
    return statistics.median(per_call) / 1e3


def device_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median over ``reps`` calls of ``fn`` of the device ms of the kernels each call
    launched, from ``torch.profiler``; the L2 cache is flushed (``flush.zero_()``)
    before each call, and the flush is not counted.

    The trace of a session can miss what the card runs first after the session
    starts: on the H100 one session lost its first three records, and another, short
    one, all of them. So each session opens with three untimed calls and a pause of
    :data:`SESSION_SETTLE_S` (records before the first marker pair count for no
    call), and a session whose trace :func:`median_call_ms` rejects is run again, up
    to :data:`SESSION_ATTEMPTS` sessions in all (``device_ms.reruns`` counts the
    sessions run again).

    The sum leaves out the card's idle gaps between one call's kernels: exact for a
    call of one launch (every CUDA kernel of the port), short of the call's device
    span for one of several (the sort path, the plain versions, the library)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(SESSION_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
            time.sleep(SESSION_SETTLE_S)
            for _ in range(reps):
                flush.zero_()
                torch.cuda._sleep(MARKER_CYCLES)
                torch.cuda._sleep(MARKER_CYCLES)
                fn()
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        records = [(e.name, e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events() if e.device_type == DeviceType.CUDA]
        try:
            return median_call_ms(records, reps)
        except RuntimeError:
            if attempt == SESSION_ATTEMPTS - 1:
                raise
            device_ms.reruns += 1


device_ms.reruns = 0


def _path_fn(path: str, view: torch.Tensor, counts: torch.Tensor):
    if path == "sort":
        return lambda: (masked_median(view, counts), masked_total(view, counts))
    return lambda: sk.fused_median_weights(view, counts, mode=path)


def measure(r: int, w: int, flush: torch.Tensor, *, seed: int = 0) -> dict[str, float]:
    """Ms of every path at ``R = r``, ``S = 64``, window ``w`` (full counts)."""
    gen = torch.Generator(device=flush.device).manual_seed(seed)
    ring = torch.rand((w, r, SIGNALS), generator=gen, device=flush.device) * 0.4 + 0.8
    view = ring.permute(1, 2, 0)
    counts = torch.full((r, SIGNALS), w, dtype=torch.int32, device=flush.device)
    row = {}
    for path in PATHS:
        fn = _path_fn(path, view, counts)
        once = device_ms(fn, 3, flush)
        reps = max(3, min(20, int(TARGET_MS / max(once, 1e-3))))
        row[path] = device_ms(fn, reps, flush)
    return row


def wins(ms: float, other_ms: float) -> bool:
    """Whether a path of ``ms`` wins a cell against one of ``other_ms``: it is not
    slower by more than :data:`TOL`."""
    return ms <= TOL * other_ms


def _loop_cap(windows, loop_best) -> int:
    # A window qualifies only while every smaller one did: one noise win past a loss
    # must not raise the cap.
    cap = 0
    for w in windows:
        if not loop_best[w]:
            break
        cap = w
    return cap


def derive(results: dict[tuple[int, int], dict[str, float]]) -> dict:
    """``loop_max_window``, ``kernel_beats_sort_at`` and ``radix_beats_sort_past_cap``
    from ``{(r, w): {path: ms}}``, by :func:`wins`."""
    windows = sorted({w for _, w in results})
    loop_best = dict.fromkeys(windows, True)
    kernel_wins = dict.fromkeys(windows, True)
    radix_wins = dict.fromkeys(windows, True)
    for (_, w), row in results.items():
        alternatives = (row["radix"], row["sort"])
        loop_best[w] &= all(wins(row["loop"], t) for t in alternatives)
        kernel_wins[w] &= wins(min(row["loop"], row["radix"]), row["sort"])
        radix_wins[w] &= wins(row["radix"], row["sort"])
    loop_max_window = _loop_cap(windows, loop_best)
    past_cap = [w for w in windows if w > loop_max_window]
    return {
        "loop_max_window": loop_max_window,
        "kernel_beats_sort_at": {str(w): kernel_wins[w] for w in windows},
        "radix_beats_sort_past_cap": bool(past_cap) and all(radix_wins[w] for w in past_cap),
    }


def run(windows=WINDOWS, ranks=RANKS, device="cuda") -> dict:
    """The whole sweep on ``device`` (a CUDA card) and what it derives."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the sweep times kernels on a CUDA card, got {dev}")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    results = {}
    for r in ranks:
        for w in windows:
            results[(r, w)] = measure(r, w, flush)
    torch.cuda.empty_cache()
    derived = derive(results)
    return {
        "signals": SIGNALS,
        "tolerance": TOL,
        "results_ms": {f"{r}x{w}": row for (r, w), row in results.items()},
        **derived,
        "export": f"{sk.MAX_WINDOW_ENV}={derived['loop_max_window']}",
        "defaults_agree": (
            derived["loop_max_window"] == sk.DEFAULT_MAX_WINDOW
            and derived["radix_beats_sort_past_cap"] == sk.DEFAULT_RADIX_AUTO
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ws", default=",".join(map(str, WINDOWS)))
    ap.add_argument("--rs", default=",".join(map(str, RANKS)))
    args = ap.parse_args(argv)
    out = run(
        windows=[int(x) for x in args.ws.split(",")],
        ranks=[int(x) for x in args.rs.split(",")],
    )
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
