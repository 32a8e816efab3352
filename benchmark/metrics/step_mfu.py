"""``step_mfu``: the least time of the step's matrix products at the card's
peaks, over the mean step time of the run's window, in %.

The products are counted from widths and counts (``harness/flops.py``):
the tracer's SDF queries over the loop iterations the device ran in the
window (``utils/graphs.py`` ``loop_iterations``), of them the bf16 ones by
the bf16 kernel's points (``ops/fused_mlp.py`` ``launch_counts``), and the
train path's differentiable points; bf16 at the bf16 peak, every other
product in float32 (three TF32 products)."""

from harness import flops


def read(ctx):
    w = ctx.window
    if not w.steps:
        return None
    march = w.loop_iterations.get("march_body", 0) / w.steps
    line = w.loop_iterations.get("line_body", 0) / w.steps
    tracer_pts = flops.tracer_points(ctx.conf["model"], ctx.rays, march, line)
    bf16_pts = w.launches.get("fused_sdf_raw_bf16", {}).get("points", 0) / w.steps
    least_s = flops.step_seconds_at_peak(ctx.d_in, ctx.feature_vector_size, ctx.rendering_dims,
                                         ctx.rays, tracer_pts, bf16_pts)
    return 100.0 * least_s / (ctx.window_s / w.steps)
