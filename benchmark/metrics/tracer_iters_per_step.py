"""``tracer_iters_per_step``: the tracer's loop iterations (march and line
search, both marches of a guided tracer), summed over the window from the
device's loop totals (``utils/graphs.py`` ``loop_iterations``, folded once
at the window's end), a step."""


def read(ctx):
    w = ctx.window
    total = sum(w.loop_iterations.values())
    if not w.steps or not total:
        return None
    return total / w.steps
