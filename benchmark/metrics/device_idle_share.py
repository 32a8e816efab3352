"""``device_idle_share``: the share of the traced window in which no
operation ran on the device (1 - the union of the device's operations from
``torch.profiler`` over the window's wall time), in %."""


def read(ctx):
    t = ctx.traced
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
