"""callback.ms_per_step: host milliseconds inside the straggler callback's step hooks
per step of the window, timed by a wrapper of the benchmark's around the program's
callback."""


def read(ctx):
    c = ctx.counters
    if not c.get("steps") or c.get("callback_s") is None:
        return None
    return 1e3 * c["callback_s"] / c["steps"]
