"""The per-layer readers on hand-made readings: each reads its share from
the counts and the trace, and returns nothing where it has nothing to
read."""

from types import SimpleNamespace as NS

import pytest

from bench_helpers import ROOT
from harness import flops, spec
from harness.driver import Counters, trace_is_whole
from harness.trace import TraceReading

CONF = {"tracer_fast": "mixed", "ray_tracer": {"n_steps": 100, "n_secant_steps": 8},
        "embedding_network": {"embed_type": "StyleModNFFB"}}
RENDER_DIMS = [278, 512, 512, 512, 512, 3]


def ctx(traced=None, traced_counts=None, steps=10, window_s=0.5):
    window = Counters(steps=steps, loop_iterations={"march_body": 130, "line_body": 150},
                      launches={"fused_sdf_raw_bf16": {"launches": 120, "points": 1_146_880}})
    return NS(conf={"model": CONF}, rays=2048, d_in=59, feature_vector_size=256,
              rendering_dims=RENDER_DIMS, window_s=window_s, window=window,
              traced=traced, traced_counts=traced_counts)


def read(name, c):
    return spec.metric_reader(ROOT, name)(c)


def test_step_mfu_and_tracer_iterations():
    c = ctx()
    pts = flops.tracer_points(CONF, 2048, 13, 15)
    least = flops.step_seconds_at_peak(59, 256, RENDER_DIMS, 2048, pts, 114_688)
    assert read("step_mfu", c) == pytest.approx(100 * least / 0.05)
    assert read("tracer_iters_per_step", c) == pytest.approx(28.0)


def test_trace_readers():
    traced = TraceReading(steps=2, window_s=0.1, busy_s=0.08, kernel_count=20_000,
                          kernel_s={"void (anonymous namespace)::bf16k::fused_sdf_kernel<64, 1>(x)":
                                    0.003},
                          kernel_n={"void (anonymous namespace)::bf16k::fused_sdf_kernel<64, 1>(x)":
                                    24})
    counts = Counters(steps=2, launches={"fused_sdf_raw_bf16": {"launches": 24, "points": 229_376},
                                         "fused_sdf_raw_f32": {"launches": 0, "points": 0}})
    assert trace_is_whole(traced, counts)
    c = ctx(traced, counts)
    assert read("device_idle_share", c) == pytest.approx(20.0)
    assert read("device_kernels_per_step", c) == pytest.approx(10_000)
    bound = flops.fused_mlp_bound_s("bf16", 229_376, 24, 59)
    assert read("bf16_mlp_roofline", c) == pytest.approx(100 * bound / 0.003)
    assert read("f32_mlp_roofline", c) is None          # no f32 kernel ran
    # a trace that lost a launch is not whole
    counts.launches["fused_sdf_raw_bf16"]["launches"] = 25
    assert not trace_is_whole(traced, counts)


def test_nothing_to_read():
    c = ctx()
    for name in ("device_idle_share", "device_kernels_per_step", "f32_mlp_roofline",
                 "bf16_mlp_roofline"):
        assert read(name, c) is None
