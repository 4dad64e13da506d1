"""profiler.window_ms: the host milliseconds a profiled step spends opening and
closing the straggler callback's profiler window (the program's ``profiler.open`` and
``profiler.close`` spans, from the span ring of ``tpu_resiliency_torch/utils/
tracing.py``), the mean over the window's profiled steps. A run whose trace saw no
device, or a program without the ring, reads nothing."""

import statistics


def read(ctx):
    from tpu_resiliency_torch.utils import tracing

    t, steps = ctx.trace, ctx.counters.get("steps")
    if t is None or not t.on_device or not steps or not hasattr(tracing, "spans"):
        return None
    lo = ctx.cell.traffic["warmup_steps"]
    by_step: dict[int, float] = {}
    for r in tracing.spans():
        if r.name in ("profiler.open", "profiler.close") and r.step is not None \
                and lo <= r.step < lo + steps:
            by_step[r.step] = by_step.get(r.step, 0.0) + r.duration_ms
    return statistics.mean(by_step.values()) if by_step else None
