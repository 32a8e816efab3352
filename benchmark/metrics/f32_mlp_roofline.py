"""``f32_mlp_roofline``: the float32 fused SDF-MLP kernel's least time for
the points and launches it ran in the traced steps (``ops/fused_mlp.py``
``launch_counts``; ``harness/flops.py``), over its device time in the trace
(``f32::fused_sdf_kernel<...>``), in %."""

from harness import flops

KERNEL = r"\bf32::fused_sdf_kernel<"
VARIANT = "fused_sdf_raw_f32"


def read(ctx):
    t, c = ctx.traced, ctx.traced_counts
    if t is None or c is None:
        return None
    device_s = t.kernel_seconds(KERNEL)
    counts = c.launches.get(VARIANT, {})
    if device_s <= 0 or not counts.get("points"):
        return None
    return 100.0 * flops.fused_mlp_bound_s("f32", counts["points"], counts["launches"],
                                           ctx.d_in) / device_s
