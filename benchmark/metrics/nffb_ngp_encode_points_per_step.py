"""``nffb_ngp_encode_points_per_step``: the points the NFFB encode kernel
encoded on the instant-ngp grid (FFBTcnn) in the run's window, both
precisions (``ops/fused_mlp.py`` ``launch_counts``: ``nffb_ngp_encode_f32``
and ``nffb_ngp_encode_bf16``), a step.  A program without that kernel
counts neither, and the metric is not reported."""

VARIANTS = ("nffb_ngp_encode_f32", "nffb_ngp_encode_bf16")


def read(ctx):
    w = ctx.window
    points = sum(w.launches.get(v, {}).get("points", 0) for v in VARIANTS)
    if not w.steps or not points:
        return None
    return points / w.steps
