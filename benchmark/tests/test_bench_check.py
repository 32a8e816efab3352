"""The comparison's numbers on hand-made readings: the per-ray colour gap
takes no notice of a few rays that land elsewhere and sees a shift of
every ray; the widest leaf gap names its leaf."""

import math

import torch

from harness import check


def _rays(n=100, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"rgb_values": torch.rand(n, 3, generator=g) * 2 - 1,
            "sdf_output": torch.rand(n, 1, generator=g) - 0.5,
            "points": torch.rand(n, 3, generator=g),
            "network_object_mask": torch.ones(n, dtype=torch.bool),
            "object_mask": torch.ones(n, dtype=torch.bool)}


def test_a_few_moved_rays_leave_the_median_and_a_shift_of_every_ray_does_not():
    ref = _rays()
    moved = {k: v.clone() for k, v in ref.items()}
    moved["rgb_values"][:5] += 0.5           # five rays landed elsewhere
    moved["network_object_mask"][95:] = False   # and five missed
    moved["sdf_output"][:5] += 0.5
    out = check.ray_gaps(moved, ref)
    assert out["rgb_ray_gap"] == 0.0 and out["sdf_ray_gap"] == 0.0
    assert out["hit_flip_share"] == 0.05 and out["surface_rays"] == 95
    shifted = dict(ref, rgb_values=ref["rgb_values"] + 1e-3, sdf_output=ref["sdf_output"] - 1e-4)
    out = check.ray_gaps(shifted, ref)
    assert math.isclose(out["rgb_ray_gap"], 1e-3, rel_tol=1e-3)
    assert math.isclose(out["sdf_ray_gap"], 1e-4, rel_tol=1e-2)


def test_rays_off_the_surface_are_not_compared_for_colour():
    ref = _rays()
    ref["object_mask"][:60] = False
    prog = {k: v.clone() for k, v in ref.items()}
    prog["rgb_values"][:60] += 1.0           # rays outside the object mask
    assert check.ray_gaps(prog, ref)["rgb_ray_gap"] == 0.0


def test_colour_of_a_few_surface_rays_is_not_a_median_and_the_sdf_still_reads():
    ref = _rays()
    ref["network_object_mask"][check.MIN_SURFACE_RAYS - 1:] = False
    prog = dict(ref, rgb_values=ref["rgb_values"] + 1e-3, sdf_output=ref["sdf_output"] + 1e-3)
    out = check.ray_gaps(prog, ref)
    assert out["rgb_ray_gap"] == 0.0 and out["surface_rays"] == check.MIN_SURFACE_RAYS - 1
    assert math.isclose(out["sdf_ray_gap"], 1e-3, rel_tol=1e-2)


def test_a_value_that_is_not_finite_reads_infinite():
    ref = _rays()
    prog = {k: v.clone() for k, v in ref.items()}
    prog["sdf_output"][3] = float("nan")
    assert all(math.isinf(v) for v in check.ray_gaps(prog, ref).values())


def test_another_number_of_rays_reads_infinite():
    ref = _rays(100)
    half = {k: v[:50] for k, v in ref.items()}
    assert math.isinf(check.ray_gaps(half, ref)["rgb_ray_gap"])


def test_widest_gap_names_its_leaf_and_its_own_gap():
    ref = {"a": 1.0, "b": 1.0, "c": 0.01}
    prog = {"a": 1.0, "b": 1.02, "c": 0.015}
    gap, leaf, own = check._widest(prog, ref)
    assert leaf == "b" and math.isclose(gap, 0.02)
    assert math.isclose(own, 0.02)
    prog = {"a": 1.0, "b": 1.0, "c": 0.04}
    gap, leaf, own = check._widest(prog, ref)
    assert leaf == "c" and math.isclose(gap, 0.03) and math.isclose(own, 3.0)
