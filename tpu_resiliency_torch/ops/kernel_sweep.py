"""Sweep the window-reduction kernels against the sort path on the card, and derive
the port's auto-selection defaults from the times.

Counterpart of ``scripts/bench_pallas_sweep.py``. For every window W and rank count R
of the grid (S = 64 signals, full windows of uniform timings), it times the ``loop``,
``pairwise`` and ``radix`` kernels and the sort path (``masked_median`` +
``masked_total``) on the telemetry ring's permuted ``[R, S, W]`` view, as
``MeshTelemetry.score`` hands it over. Each time is the median of several launches,
each between its own CUDA events, with the L2 cache flushed before it (a report finds
the ring cold). Two results follow. A path "wins" a cell against another unless it
is slower by more than the TPU sweep's 2% (``TOL``) and by more than ``ABS_TOL_MS``:

- ``loop_max_window``: the largest W such that ``loop`` wins against ``radix`` and
  against the sort at every R, for it and every smaller W. It is the port's default
  cap (``scoring_kernels.DEFAULT_MAX_WINDOW``; override:
  ``$TPU_RESILIENCY_CUDA_MAX_WINDOW``).
- ``kernel_beats_sort_at``: per W, whether the better auto-selectable kernel
  (``loop`` or ``radix``) wins against the sort at every R; and
  ``radix_beats_sort_past_cap``, whether ``radix`` does at every W past the cap, which
  sets ``scoring_kernels.DEFAULT_RADIX_AUTO`` (override: ``$TPU_RESILIENCY_CUDA_RADIX``).

The absolute term is the port's addition to the TPU rule. On the H100 every path
takes 0.02-0.07 ms at R = 256 and W <= 128, whatever its work (a single cold launch);
there a relative 2% is a few microseconds, below the floor's own scatter, and the
TPU rule alone can hand config 4 (R = 4096, W = 32) from ``loop`` to a slower
``radix`` over a few microseconds at R = 256 (with the one-bit-pass radix, 3.5 times
slower, it once did). ``ABS_TOL_MS`` is half that floor.
``loop_max_window_relative_only`` reports what the TPU rule alone gives.

``pairwise`` is timed but never votes: it is never auto-selected.

Run on a CUDA card from the root of a checkout::

    python -m tpu_resiliency_torch.ops.kernel_sweep [--ws 32,64,128] [--rs 256,4096]

It prints one JSON object. ``chip_smoke.py`` runs it as its ``sweep`` phase.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from tpu_resiliency_torch.ops import scoring_kernels as sk
from tpu_resiliency_torch.telemetry.scoring import masked_median, masked_total

WINDOWS = (32, 64, 128, 256, 512, 1024)
RANKS = (256, 1024, 4096)
SIGNALS = 64
TOL = 1.02
ABS_TOL_MS = 0.02
PATHS = ("loop", "pairwise", "radix", "sort")
L2_FLUSH_BYTES = 64 << 20  # larger than the H100's 50 MB L2
TARGET_MS = 300.0  # timed work per cell and path, to choose its repetitions


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median ms of ``reps`` calls of ``fn``, each between its own CUDA events with
    the L2 cache flushed (``flush.zero_()``) before it. Three untimed calls first."""
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
        once = time_ms(fn, 1, flush)
        reps = max(3, min(20, int(TARGET_MS / max(once, 1e-3))))
        row[path] = time_ms(fn, reps, flush)
    return row


def wins(ms: float, other_ms: float, abs_tol_ms: float = ABS_TOL_MS) -> bool:
    """Whether a path of ``ms`` wins a cell against one of ``other_ms``: it is not
    slower by more than both :data:`TOL` and ``abs_tol_ms``."""
    return ms <= TOL * other_ms or ms - other_ms <= abs_tol_ms


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
    from ``{(r, w): {path: ms}}``, by :func:`wins`; and ``loop_max_window_relative_only``,
    the cap under the TPU sweep's relative tolerance alone."""
    windows = sorted({w for _, w in results})
    loop_best = dict.fromkeys(windows, True)
    loop_best_relative = dict.fromkeys(windows, True)
    kernel_wins = dict.fromkeys(windows, True)
    radix_wins = dict.fromkeys(windows, True)
    for (_, w), row in results.items():
        alternatives = (row["radix"], row["sort"])
        loop_best[w] &= all(wins(row["loop"], t) for t in alternatives)
        loop_best_relative[w] &= all(wins(row["loop"], t, 0.0) for t in alternatives)
        kernel_wins[w] &= wins(min(row["loop"], row["radix"]), row["sort"])
        radix_wins[w] &= wins(row["radix"], row["sort"])
    loop_max_window = _loop_cap(windows, loop_best)
    past_cap = [w for w in windows if w > loop_max_window]
    return {
        "loop_max_window": loop_max_window,
        "loop_max_window_relative_only": _loop_cap(windows, loop_best_relative),
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
        "abs_tolerance_ms": ABS_TOL_MS,
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
