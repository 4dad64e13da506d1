"""detector.report_ms: the median host milliseconds of the straggler detector's
reports in the window (the program's ``detector.report`` span: the summary, the
scoring on the card and the report built on the host; from the span ring of
``tpu_resiliency_torch/utils/tracing.py``). A run whose trace saw no device, or a
program without the ring, reads nothing."""

import statistics


def read(ctx):
    from tpu_resiliency_torch.utils import tracing

    t, steps = ctx.trace, ctx.counters.get("steps")
    if t is None or not t.on_device or not steps or not hasattr(tracing, "spans"):
        return None
    lo = ctx.cell.traffic["warmup_steps"]
    ms = [r.duration_ms for r in tracing.spans("detector.report")
          if r.step is not None and lo <= r.step < lo + steps]
    return statistics.median(ms) if ms else None
