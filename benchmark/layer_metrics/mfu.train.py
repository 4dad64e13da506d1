"""mfu.train: the whole train step's share of the card's bf16 peak, in percent: the
operations the window's tokens need (``roofline.train_flop_per_token``) over the
window's host-clock seconds and the published 989 TFLOP/s. A run whose trace saw no
device (the CPU's) reads nothing."""

from benchmark import roofline


def read(ctx):
    c, cfg = ctx.counters, ctx.cell.config
    if ctx.trace is None or not ctx.trace.on_device or not c.get("tokens") \
            or not c.get("window_s"):
        return None
    per_token = roofline.train_flop_per_token(
        cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
        cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"],
        cfg["assumed"]["seq_len"])
    return roofline.share_percent(c["tokens"] * per_token / roofline.BF16_FLOP_PER_S,
                                  c["window_s"])
