"""The FFBTcnn cell's pieces: the ngp encode kernel's least time on a shape
worked by hand, its two metrics on hand-made readings (and nothing where a
program has no such kernel, as the parent has not), and on the card the
cell's limits separating the program from its control and its faults:

    python -m pytest benchmark/tests/test_bench_ffbtcnn.py -q [-m cuda]
"""

from types import SimpleNamespace as NS

import pytest
import torch

from bench_helpers import ROOT
from harness import nffb_ngp_encode, spec
from harness.driver import Counters
from harness.trace import TraceReading

WORKLOAD = "ffbtcnn15.dtu49.mixed"
KERNEL = ("void (anonymous namespace)::nffb_encode_kernel<(anonymous namespace)::NgpGrid, 6, 28, "
          "true, true>((anonymous namespace)::NgpGrid::Args)")
TORCH_KERNEL = ("void (anonymous namespace)::nffb_encode_kernel<(anonymous namespace)::TorchGrid, "
                "6, 56, true, true>((anonymous namespace)::Params)")


def test_ngp_encode_bound_on_the_published_points_encoder():
    """6 levels x 2 features, 2^15 rows, resolution 16 to 512, style: the 4
    used levels' 8 corners, 4 multiply-adds each (2 weight products, 2
    features) 128; the style transform 4 x 28 x 28 = 3,136; the trunk 3 x 28
    + 4 x 28 x 28 = 3,220; the out layer 784: 7,268 a point.  A launch
    reads 4,984 weight floats and the used levels' 4,920 + 3 x 32,768 rows
    of 2 floats.  At N = 4,096 the products (0.889 us) outweigh the bytes
    (136 a point and 845,728 a launch, 0.419 us)."""
    assert nffb_ngp_encode.level_rows(6, 15, 16, 512) == [4920] + [32768] * 5
    assert nffb_ngp_encode.level_rows(4, 3, 16, 512) == [8] * 4
    assert nffb_ngp_encode.macs_per_point(6, 2) == 7268
    assert nffb_ngp_encode.weight_bytes(6, 2) == 4 * 4984
    assert nffb_ngp_encode.launch_bytes(6, 2, 15, 16, 512) == 4 * 4984 + 8 * 103224
    ops_s = 2 * 7268 * 4096 / 67e12
    bytes_s = (4096 * 136 + 845_728) / 3.35e12
    assert ops_s > bytes_s
    assert nffb_ngp_encode.bound_s(4096, 1, 6, 2, 15, 16, 512) == pytest.approx(ops_s)
    # few points a launch: the bytes bound it
    assert nffb_ngp_encode.bound_s(64, 1, 6, 2, 15, 16, 512) == pytest.approx(
        (64 * 136 + 845_728) / 3.35e12)


def test_points_encoder_reads_the_cells_conf():
    cell = spec.resolve(ROOT, WORKLOAD)
    assert nffb_ngp_encode.points_encoder(cell.conf["model"]) == {
        "levels": 6, "features": 2, "log2_rows": 15, "base_resolution": 16,
        "desired_resolution": 512, "style": True}


COUNTS = {"nffb_ngp_encode_bf16": {"launches": 120, "points": 1_146_880},
          "nffb_ngp_encode_f32": {"launches": 300, "points": 1_228_800},
          "nffb_encode_f32": {"launches": 7, "points": 9_999}}


def ctx(launches, traced=None, steps=10):
    cell = spec.resolve(ROOT, WORKLOAD)
    counts = Counters(steps=steps, launches=launches)
    return NS(conf=cell.conf, window=counts, traced=traced,
              traced_counts=counts if traced is not None else None)


def read(name, c):
    return spec.metric_reader(ROOT, name)(c)


def test_ngp_encode_points_per_step():
    assert read("nffb_ngp_encode_points_per_step", ctx(COUNTS)) == pytest.approx(
        (1_146_880 + 1_228_800) / 10)


def test_ngp_encode_roofline():
    traced = TraceReading(steps=10, window_s=0.6, busy_s=0.5, kernel_count=100,
                          kernel_s={KERNEL: 0.02, TORCH_KERNEL: 0.5, "other": 0.3},
                          kernel_n={KERNEL: 420, TORCH_KERNEL: 10})
    bound = nffb_ngp_encode.bound_s(1_146_880 + 1_228_800, 420, 6, 2, 15, 16, 512)
    assert read("nffb_ngp_encode_roofline", ctx(COUNTS, traced)) == pytest.approx(
        100 * bound / 0.02)


def test_ngp_metrics_read_nothing_without_the_kernel():
    """A program without the ngp kernel (the parent) counts none of its
    launches and has no such kernel in its trace: both metrics are left
    out, and neither raises."""
    parent = {"fused_sdf_raw_bf16": {"launches": 120, "points": 1_146_880}}
    traced = TraceReading(steps=10, window_s=0.6, busy_s=0.5, kernel_count=100,
                          kernel_s={"void at::native::elementwise_kernel<...>": 0.3},
                          kernel_n={"void at::native::elementwise_kernel<...>": 100})
    assert read("nffb_ngp_encode_points_per_step", ctx(parent)) is None
    assert read("nffb_ngp_encode_points_per_step", ctx({}, steps=0)) is None
    assert read("nffb_ngp_encode_roofline", ctx(parent, traced)) is None
    assert read("nffb_ngp_encode_roofline", ctx(COUNTS)) is None        # no trace
    # counted launches but a trace that holds none of the kernel
    assert read("nffb_ngp_encode_roofline", ctx(COUNTS, traced)) is None


@pytest.mark.cuda
def test_ffbtcnn_program_passes_and_control_fails(cuda_card):
    from harness import check, driver
    from harness.scene import build_scene
    from reference import step as ref_step

    cell = spec.resolve(ROOT, WORKLOAD)
    scene = build_scene(cell.traffic, cuda_card)
    st = driver.start(cell, scene, 2_147_483_711, cuda_card)
    prog, weights, checked = st.prog, st.weights, st.checked
    del st
    driver.free(cuda_card)
    ref = ref_step.run_steps(cell.conf, scene, weights, checked)
    assert check.verdict(check.gaps(prog, ref, weights), cell.limits)
    for kw in ({"tf32": True, "guide_dtype": torch.float8_e4m3fn}, {"tf32": True},
               {"keep_rays": cell.traffic["rays_per_step"] // 2}):
        other = ref_step.run_steps(cell.conf, scene, weights, checked, **kw)
        assert not check.verdict(check.gaps(other, ref, weights), cell.limits), kw
