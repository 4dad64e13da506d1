"""train.idle_share: the share of the traced train steps' window in which nothing ran
on the device, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.on_device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
