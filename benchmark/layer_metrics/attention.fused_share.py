"""attention.fused_share: the share of the window's dense attention calls that ran the
hand-written causal softmax kernel, in percent: the ``attention_fused`` over the
``attention_fused`` plus ``attention_plain`` counts of the program's ``model.forward``
spans (from the span ring of ``tpu_resiliency_torch/utils/tracing.py``), summed over
the window's steps. A run whose trace saw no device, a program without the ring, or
one whose spans carry no such counts, reads nothing."""


def read(ctx):
    from tpu_resiliency_torch.utils import tracing

    t, steps = ctx.trace, ctx.counters.get("steps")
    if t is None or not t.on_device or not steps or not hasattr(tracing, "spans"):
        return None
    lo = ctx.cell.traffic["warmup_steps"]
    counts = [r.counts for r in tracing.spans("model.forward")
              if r.step is not None and lo <= r.step < lo + steps
              and "attention_fused" in r.counts]
    fused = sum(c["attention_fused"] for c in counts)
    total = fused + sum(c["attention_plain"] for c in counts)
    return 100.0 * fused / total if total else None
