"""``encoder_fused_points_per_step`` on hand-made window counts: both
precisions' points a step, and nothing where the program has no encode
kernel (a parent without its counters)."""

from types import SimpleNamespace as NS

import pytest

from bench_helpers import ROOT
from harness import spec
from harness.driver import Counters


def read(launches, steps=10):
    ctx = NS(window=Counters(steps=steps, launches=launches))
    return spec.metric_reader(ROOT, "encoder_fused_points_per_step")(ctx)


def test_encoder_fused_points_per_step():
    mixed = {"fused_sdf_raw_bf16": {"launches": 120, "points": 1_146_880},
             "nffb_encode_bf16": {"launches": 120, "points": 1_146_880},
             "nffb_encode_f32": {"launches": 300, "points": 1_228_800}}
    assert read(mixed) == pytest.approx((1_146_880 + 1_228_800) / 10)
    assert read({"nffb_encode_f32": {"launches": 21, "points": 135_168}}, steps=1) == 135_168


def test_encoder_fused_points_per_step_reads_nothing_without_the_kernel():
    assert read({"fused_sdf_raw_bf16": {"launches": 120, "points": 1_146_880}}) is None
    assert read({"nffb_encode_f32": {"launches": 0, "points": 0}}) is None
    assert read({}, steps=0) is None
