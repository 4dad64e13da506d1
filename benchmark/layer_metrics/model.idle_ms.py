"""model.idle_ms: device milliseconds per traced step in which the device was idle
while the host was inside one of the program's ``model.*`` spans (forward, backward,
optimizer; from the span ring of ``tpu_resiliency_torch/utils/tracing.py``). Each idle
gap of the trace is cut at the spans' edges and only its pieces inside a span count:
the join rests on the ring and the trace sharing one clock. A run whose trace saw no
device, or a program without the ring, reads nothing."""


def read(ctx):
    from tpu_resiliency_torch.utils import tracing

    t, steps = ctx.trace, ctx.counters.get("steps")
    if t is None or not t.on_device or not steps or not hasattr(tracing, "spans"):
        return None
    lo, hi = t.window
    first = ctx.cell.traffic["warmup_steps"]
    host = sorted((r.start_ns * 1e-9, r.end_ns * 1e-9, r.step) for r in tracing.spans()
                  if r.name.startswith("model.") and r.step is not None
                  and first <= r.step < first + steps
                  and r.end_ns * 1e-9 > lo and r.start_ns * 1e-9 < hi)
    if not host:
        return None
    idle, edge = [], lo
    for a, b in t.busy(lo, hi) + [[hi, hi]]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    inside, reach = 0.0, lo  # ``reach``: where the spans counted so far end
    for a, b, _ in host:
        a = max(a, reach)
        for ia, ib in idle:
            inside += max(0.0, min(b, ib) - max(a, ia))
        reach = max(reach, b)
    return 1e3 * inside / len({step for _, _, step in host})
