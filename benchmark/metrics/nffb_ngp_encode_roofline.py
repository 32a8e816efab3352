"""``nffb_ngp_encode_roofline``: the NFFB encode kernel on the instant-ngp
grid, its least time for the points and launches it ran in the traced
steps (``ops/fused_mlp.py`` ``launch_counts``: ``nffb_ngp_encode_f32`` and
``nffb_ngp_encode_bf16``; ``harness/nffb_ngp_encode.py``), over its device
time in the trace (``nffb_encode_kernel<(anonymous namespace)::NgpGrid,
...>``), in %.  The train step sends it the SDF encoder's gradient-free
queries only (the view directions are encoded with autograd), so the bound
is the SDF encoder's shape, from the conf.  A program or a trace without
the kernel reads nothing."""

from harness import nffb_ngp_encode

KERNEL = r"\bnffb_encode_kernel<[^,<>]*\bNgpGrid,"
VARIANTS = ("nffb_ngp_encode_f32", "nffb_ngp_encode_bf16")


def read(ctx):
    t, c = ctx.traced, ctx.traced_counts
    if t is None or c is None:
        return None
    device_s = t.kernel_seconds(KERNEL)
    points = sum(c.launches.get(v, {}).get("points", 0) for v in VARIANTS)
    launches = sum(c.launches.get(v, {}).get("launches", 0) for v in VARIANTS)
    if device_s <= 0 or not points:
        return None
    shape = nffb_ngp_encode.points_encoder(ctx.conf["model"])
    return 100.0 * nffb_ngp_encode.bound_s(points, launches, **shape) / device_s
