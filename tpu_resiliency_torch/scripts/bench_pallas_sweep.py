"""Sweep the whole scoring round over (W, R), per window-reduction kernel and for the
sort path, and derive the port's auto-selection defaults from the times.

Port of ``scripts/bench_pallas_sweep.py``. Where ``ops/kernel_sweep.py`` (the sweep
behind ``scoring_kernels.auto_mode``) times the window reduction alone, this times what
a report pays: ``scoring.score_round`` over ``fused_median_weights(mode=...)`` for the
``loop``, ``pairwise`` and ``radix`` kernels, and ``score_round`` with its own sort-based
reduction for ``sort``, each round fed the last round's ``ewma``, on the reference's
seeded uniform timings (S = 64, full windows). ``pairwise`` runs only at W <= 64, the
reference's rule. Each cell is the median over ``ITERS`` calls of the CUDA-event span
of one call, with the L2 cache flushed before each (``kernel_sweep.time_ms``, a
``kernel_sweep.L2_FLUSH_BYTES`` flush: a report finds the ring cold); on ``--device
cpu`` the kernel modes run their plain versions and a cell is the host's clock over
``ITERS`` calls.

The derivation is ``kernel_sweep.derive``, by ``kernel_sweep.wins`` and its ``TOL``
(2%, the reference's): ``loop_max_window`` is the largest W at which ``loop`` wins
against ``radix`` and the sort at every R, for it and every smaller W (one noise win
past a loss does not raise it); ``pairwise`` votes in neither export, as it is never
auto-selected.

The JSON line keeps the reference's keys where the meaning carries: ``backend``,
``signals``, ``results_ms``, ``loop_max_window``, ``loop_tolerance``. Renamed:

- the variants ``pallas-loop``, ``pallas-pairwise``, ``pallas-radix``, ``xla`` are
  ``loop``, ``pairwise``, ``radix``, ``sort`` (in ``results_ms`` too);
- ``pallas_beats_xla_at`` is ``kernel_beats_sort_at``;
- ``export`` names ``TPU_RESILIENCY_CUDA_MAX_WINDOW`` (the reference's
  ``TPU_RESILIENCY_PALLAS_MAX_WINDOW``).

Added: ``radix_beats_sort_past_cap`` (the verdict behind
``scoring_kernels.DEFAULT_RADIX_AUTO``), ``device_kind`` and ``card`` (``nvidia-smi``'s
name and power limit). Dropped: ``carried_cells`` and ``note``, the reference's fields
for merging a wedged TPU run's cells into its committed file; a failed cell fails the
run here.

Run from the root of a checkout::

    python -m tpu_resiliency_torch.scripts.bench_pallas_sweep [--ws 32,64,128,256] \\
        [--rs 256,1024,4096] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from tpu_resiliency_torch.ops import kernel_sweep

S = 64
ITERS = 20
TOL = kernel_sweep.TOL
VARIANTS = ("loop", "pairwise", "radix", "sort")
#: ``pairwise`` runs only up to this window (the reference's rule).
PAIRWISE_MAX_WINDOW = 64


def measure(r: int, w: int, variant: str, device=None, flush=None) -> float:
    """Ms of one scoring round of ``variant`` at ``R = r``, ``S = 64``, window ``w``.
    ``flush``: the L2 flush buffer on the card (made here when ``None``)."""
    import torch

    from tpu_resiliency_torch.ops.scoring_kernels import fused_median_weights
    from tpu_resiliency_torch.platform.device import resolve_device
    from tpu_resiliency_torch.telemetry import scoring

    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    data = torch.as_tensor(rng.uniform(0.8, 1.2, (r, S, w)).astype(np.float32), device=dev)
    counts = torch.full((r, S), w, dtype=torch.int32, device=dev)
    hist = torch.full((r, S), float("inf"), device=dev)
    mode = None if variant == "sort" else variant
    state = {"ewma": torch.ones((r,), device=dev)}

    def program():
        mw = None if mode is None else fused_median_weights(data, counts, mode=mode)
        state["ewma"] = scoring.score_round(data, counts, state["ewma"], hist,
                                            medians_and_weights=mw).ewma

    if dev.type == "cuda":
        if flush is None:
            flush = torch.empty(kernel_sweep.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                device=dev)
        return kernel_sweep.time_ms(program, ITERS, flush)
    program()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        program()
    return (time.perf_counter() - t0) / ITERS * 1e3


def run(ws, rs, device=None) -> dict:
    """Every cell of ``ws`` x ``rs`` and what it derives (see the module's docstring)."""
    import torch

    from tpu_resiliency_torch.platform.device import resolve_device

    dev = resolve_device(device)
    flush = None
    if dev.type == "cuda":
        flush = torch.empty(kernel_sweep.L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    results = {}
    for r in rs:
        for w in ws:
            row = {v: measure(r, w, v, dev, flush) for v in VARIANTS
                   if v != "pairwise" or w <= PAIRWISE_MAX_WINDOW}
            results[(r, w)] = row
            verdict = kernel_sweep.wins(min(row["loop"], row["radix"]), row["sort"])
            cells = "  ".join(f"{k}={v:.3f}ms" for k, v in row.items())
            print(f"R={r:5d} W={w:4d}: {cells}  -> {'kernel' if verdict else 'sort'}",
                  file=sys.stderr)
    if dev.type == "cuda":
        del flush
        torch.cuda.empty_cache()
    return summarize(results, dev)


def summarize(results: dict[tuple[int, int], dict[str, float]], dev) -> dict:
    """The JSON line of the cells ``{(r, w): {variant: ms}}`` measured on ``dev``."""
    from tpu_resiliency_torch.ops.scoring_kernels import MAX_WINDOW_ENV
    from tpu_resiliency_torch.scripts import device_fields

    derived = kernel_sweep.derive(results)
    fields = device_fields(dev)
    return {
        "backend": fields["backend"],
        "signals": S,
        "results_ms": {f"{r}x{w}": row for (r, w), row in results.items()},
        "loop_max_window": derived["loop_max_window"],
        "loop_tolerance": TOL,
        "kernel_beats_sort_at": derived["kernel_beats_sort_at"],
        "radix_beats_sort_past_cap": derived["radix_beats_sort_past_cap"],
        "export": f"{MAX_WINDOW_ENV}={derived['loop_max_window']}",
        "device_kind": fields["device_kind"],
        "card": fields["card"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ws", default="32,64,128,256")
    ap.add_argument("--rs", default="256,1024,4096")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    from tpu_resiliency_torch.platform.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_pallas_sweep: {e}", file=sys.stderr)
        return 1
    print(json.dumps(run([int(x) for x in args.ws.split(",")],
                         [int(x) for x in args.rs.split(",")], device=dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
