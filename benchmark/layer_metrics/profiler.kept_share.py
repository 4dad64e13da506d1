"""profiler.kept_share: the share of the trace records that the straggler callback's
profiler windows parse which become detector samples (region and kernel samples), in
percent: the ``samples`` over the ``records`` of the program's ``profiler.close``
spans (from the span ring of ``tpu_resiliency_torch/utils/tracing.py``), summed over
the window's profiled steps. A run whose trace saw no device, or a program without the
ring, reads nothing."""


def read(ctx):
    from tpu_resiliency_torch.utils import tracing

    t, steps = ctx.trace, ctx.counters.get("steps")
    if t is None or not t.on_device or not steps or not hasattr(tracing, "spans"):
        return None
    lo = ctx.cell.traffic["warmup_steps"]
    closes = [r.counts for r in tracing.spans("profiler.close")
              if r.step is not None and lo <= r.step < lo + steps and "records" in r.counts]
    records = sum(c["records"] for c in closes)
    if not records:
        return None
    return 100.0 * sum(c["samples"] for c in closes) / records
