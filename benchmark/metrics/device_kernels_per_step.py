"""``device_kernels_per_step``: the kernels the profiler saw run on the
device over the traced steps (those inside the graph's while-nodes too),
a step."""


def read(ctx):
    t = ctx.traced
    if t is None or not t.kernel_count:
        return None
    return t.kernel_count / t.steps
