"""mfu.moe_train: the hybrid MoE train step's share of the card's bf16 peak, in percent:
the operations the window's tokens need (``roofline_moe.train_flop_per_token``: the
active products, 4 of 64 experts a routed layer, the tied head's, and causal
attention's) over the window's host-clock seconds and the published 989 TFLOP/s. A run
whose trace saw no device (the CPU's) reads nothing."""

from benchmark import roofline_moe


def read(ctx):
    c = ctx.counters
    if ctx.trace is None or not ctx.trace.on_device or not c.get("tokens") \
            or not c.get("window_s"):
        return None
    flop = c["tokens"] * roofline_moe.train_flop_per_token(ctx.cell.config)
    return roofline_moe.share_of_peak(flop, c["window_s"])
