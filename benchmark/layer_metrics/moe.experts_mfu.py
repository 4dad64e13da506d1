"""moe.experts_mfu: the routed experts' products' share of the card's bf16 peak, in
percent: the operations a step's tokens need in them (``roofline_moe.routed_flop``,
from the shapes alone) over ``moe.experts_ms`` and the published 989 TFLOP/s. A run
that reads no ``moe.experts_ms`` reads nothing."""

from benchmark import roofline_moe
from benchmark import program_spans


def read(ctx):
    ms = program_spans.device_ms_per_step(ctx, "moe.experts")
    if ms is None:
        return None
    cfg = ctx.cell.config
    tokens = cfg["assumed"]["seq_len"] * cfg["assumed"]["micro_batch"]
    return roofline_moe.share_of_peak(roofline_moe.routed_flop(cfg, tokens), ms * 1e-3)
