"""The yardstick's operations, bytes and rooflines on hand-worked shapes."""

import pytest

from harness import flops

# the rendering MLP of both configurations: points 3 + SH degree 4 (16) +
# normals 3 + 256 features in, 4x512, RGB out
RENDER_DIMS = [278, 512, 512, 512, 512, 3]


def test_fused_kernel_macs():
    # l0 59x512, l1-l2 512x512, l3 512x453, l4-l7 512x512, the SDF column
    assert flops.fused_mlp_macs(59) == 59 * 512 + 2 * 512 * 512 + 512 * 453 + 4 * 512 * 512 + 512
    assert 2 * flops.fused_mlp_macs(59) == 3_671_040


@pytest.mark.parametrize("precision, n, bound_ms", [
    ("f32", 49152, 1.094),   # PERF.md's kernel table: operations bound it
    ("bf16", 4096, 0.0152),
    ("f32", 256, 0.0057),
    ("bf16", 69632, 0.2585),
    ("bf16", 256, 0.0011),   # bytes bound it: 3.67 MB of bf16 weights a launch
])
def test_fused_kernel_bound_matches_the_kernel_table(precision, n, bound_ms):
    digits = len(repr(bound_ms).split(".")[1])     # as the table rounds them
    assert round(flops.fused_mlp_bound_s(precision, n, 1, 59) * 1e3, digits) == bound_ms


def test_bound_over_folded_counts_is_no_larger_than_the_launches():
    one = flops.fused_mlp_bound_s("bf16", 256, 1, 59)
    assert flops.fused_mlp_bound_s("bf16", 2 * 256, 2, 59) <= 2 * one + 1e-15


def test_sweep_stride():
    assert flops.sweep_stride(100, guided_coarse=False) == 9
    # guided on the card: the smallest cost ((n-1)//s+1)*0.4 + 3(s-1) of s in 9, 11, 3
    assert flops.sweep_stride(100, guided_coarse=True) == 3


def _model(mode, embed="StyleModNFFB", **rt):
    ray_tracer = {"n_steps": 100, "n_secant_steps": 8, **rt}
    return {"tracer_fast": mode, "ray_tracer": ray_tracer,
            "embedding_network": {"embed_type": embed}}


def test_tracer_points_exact():
    # one march: 2R at its start + 2R a march and a line-search iteration;
    # sweep stride 9: 12 coarse + 24 fine probes a ray; 8 secant points
    R = 2048
    assert flops.tracer_points(_model("exact"), R, 10, 3) == 2 * R * (1 + 10 + 3) + R * 36 + 8 * R


def test_tracer_points_mixed_ngp_guided_secant():
    # two marches; stride 3: 34 coarse + 6 fine + 5 exact endpoints; the
    # guided secant's exact call on both ends
    R = 2048
    m = _model("mixed", "HashGridTcnn", prune_levels_march=16, prune_levels_coarse=16,
               prune_secant_iters=4)
    assert flops.tracer_guides(m) == {"march": True, "coarse": True, "secant": True}
    assert flops.tracer_points(m, R, 12, 4) == (2 * R * (2 + 12 + 4) + R * (34 + 6 + 5)
                                                 + 8 * R + 2 * R)


def test_train_path_macs():
    R = 2048
    f1 = 59 * 512 + 6 * 512 * 512 + 512 * 453 + 512
    f_all = f1 - 512 + 512 * 257
    f_r = 278 * 512 + 3 * 512 * 512 + 512 * 3
    want = 3 * f1 * R + 6 * f1 * (R + R // 2) + 3 * f_all * R + 3 * f1 * R + 3 * f_r * R
    assert flops.train_path_macs(59, 256, RENDER_DIMS, R) == want


def test_step_at_peak():
    # 135,168 f32 tracer points (the exact+fused step's) and the train path:
    # about 3.9 ms of float32 products at 495/3 TFLOP/s
    s = flops.step_seconds_at_peak(59, 256, RENDER_DIMS, 2048, 135168, 0)
    assert s * 1e3 == pytest.approx(3.9, abs=0.1)
    # moving tracer points to bf16 lowers the least time
    assert flops.step_seconds_at_peak(59, 256, RENDER_DIMS, 2048, 135168, 100000) < s
