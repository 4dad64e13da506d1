"""model.forward_ms: the median, over the window's steps, of the device milliseconds of
the program's ``model.forward`` span (its device interval, from the span ring of
``tpu_resiliency_torch/utils/tracing.py``). A run whose trace saw no device, or a
program without the ring, reads nothing."""

import statistics


def read(ctx):
    from tpu_resiliency_torch.utils import tracing

    t, steps = ctx.trace, ctx.counters.get("steps")
    if t is None or not t.on_device or not steps or not hasattr(tracing, "spans"):
        return None
    lo = ctx.cell.traffic["warmup_steps"]
    ms = [r.device_ms for r in tracing.spans("model.forward")
          if r.step is not None and lo <= r.step < lo + steps]
    if not ms or None in ms:
        return None
    return statistics.median(ms)
