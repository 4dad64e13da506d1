"""What the per-layer readers of program spans share: a span's device time per step."""

import statistics


def device_ms_per_step(ctx, name: str):
    """The median, over the window's steps, of the summed device milliseconds of the
    program's ``name`` spans in each step; ``None`` where the trace saw no device, the
    program has no span ring, or a step's span has no device interval."""
    from tpu_resiliency_torch.utils import tracing

    t, steps = ctx.trace, ctx.counters.get("steps")
    if t is None or not t.on_device or not steps or not hasattr(tracing, "spans"):
        return None
    lo = ctx.cell.traffic["warmup_steps"]
    by_step: dict[int, float] = {}
    for r in tracing.spans(name):
        if r.step is not None and lo <= r.step < lo + steps:
            if r.device_ms is None:
                return None
            by_step[r.step] = by_step.get(r.step, 0.0) + r.device_ms
    return statistics.median(by_step.values()) if by_step else None
