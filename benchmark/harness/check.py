"""The comparison that decides ``correct``: the program's first steps
against the plain reference's on the same weights and inputs.

The numbers, each a widest gap but the per-ray medians; a cell compares those its limits file
names (``benchmark/limits/<cell>.json``):
  * ``loss1_gap``: |program's loss - the reference's| / |the reference's|
    at the first step, from the same weights (the steady one: Adam's
    first updates of near-nought gradient entries are a sign apart
    wherever rounding differs, so the later steps' losses carry that
    noise);
  * ``loss_gap``, ``rgb_gap``, ``eikonal_gap``, ``mask_gap``: the same over
    the first three steps, of the loss and of each of its terms;
  * ``grad_gap``: over the leaves, the gap between the norms of the first
    step's clipped gradient (the program's worked out from its Adam state
    after one step: ``exp_avg / (1 - b1)``) measured against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger;
  * ``change_gap``: the same of the parameters' change over the three
    steps, over the leaves whose reference gradient is not nought to
    rounding at some step (its norm at least a thousandth of the median
    leaf's: a leaf with no gradient moves under Adam by round-off alone).
    The rule is on every step's gradient, not the first's: the geometric
    init gives the SDF MLP's first layer zero weights on the encoder's
    columns, so the encoder has no gradient at the first step and moves
    from the second.
  * ``rgb_ray_gap``: the first step's rendered colour, ray by ray, from
    the same weights: over the rays that both sides put on the surface
    (the tracer's hit mask and the object mask), the median of the
    widest channel gap; 0 where fewer than ``MIN_SURFACE_RAYS`` rays are
    on the surface on both sides, since a median of a few rays is one
    ray's.  A median, because the bf16 guidance's rounding (the kernel's
    against its plain twin) moves a few rays' landings, while a lower
    precision of the float32 products moves every ray;
  * ``sdf_ray_gap``: the median over every ray of the gap between the
    two sides' SDF at the ray's point (the surface point, or the
    sweep's closest point of a ray that misses), so it reads where no
    ray meets the surface too.
  A side that rendered another number of rays, or a value that is not
  finite, reads infinite on both.  ``hit_flip_share`` (the share of rays
  whose hit masks differ), ``point_ray_gap`` (the median distance
  between the two sides' points on the rays both put on the surface)
  and ``surface_rays`` (their count) are printed beside them.
Beside ``grad_gap`` and ``change_gap`` come the leaf that sets each
(``grad_leaf``, ``change_leaf``) and its gap over its own reference norm
(``grad_leaf_own``, ``change_leaf_own``), as readings.
A leaf that one side leaves without a gradient counts on neither; a leaf
whose reference norm and the median's are both 0 counts as 0 where the
program's is 0 too."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import torch

IGNORED_GRAD_SHARE = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _ratio(gap: float, scale: float) -> float:
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def _widest(prog: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str, float]:
    """The widest gap, the leaf that sets it and that leaf's gap over its
    own reference norm."""
    if not ref:
        return 0.0, "", 0.0
    floor = statistics.median(ref.values())
    gaps = {k: _ratio(abs(prog[k] - ref[k]), max(ref[k], floor)) for k in ref}
    leaf = max(gaps, key=gaps.get)
    own = _ratio(abs(prog[leaf] - ref[leaf]), ref[leaf])
    if not all(math.isfinite(g) for g in gaps.values()):
        return math.inf, leaf, own
    return gaps[leaf], leaf, own


MIN_SURFACE_RAYS = 16
RAY_NUMBERS = ("rgb_ray_gap", "sdf_ray_gap", "hit_flip_share", "point_ray_gap", "surface_rays")


def _median(v: torch.Tensor) -> float:
    return float(v.double().median()) if v.numel() else 0.0


def ray_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of the first step's per-ray outputs (``rgb_values``,
    ``sdf_output``, ``points``, ``network_object_mask``, ``object_mask``)."""
    if any(prog[k].shape != ref[k].shape for k in ref):
        return {k: math.inf for k in RAY_NUMBERS}
    p = {k: v.to(ref[k].device) for k, v in prog.items()}
    if not all(bool(torch.isfinite(p[k]).all()) for k in ("rgb_values", "sdf_output", "points")):
        return {k: math.inf for k in RAY_NUMBERS}
    hit_p, hit_r = p["network_object_mask"].bool(), ref["network_object_mask"].bool()
    both = hit_p & hit_r & ref["object_mask"].bool()
    rgb = (p["rgb_values"] - ref["rgb_values"]).abs().amax(dim=-1)[both]
    pts = torch.linalg.vector_norm(p["points"] - ref["points"], dim=-1)[both]
    sdf = (p["sdf_output"] - ref["sdf_output"]).abs().reshape(-1)
    return {"rgb_ray_gap": _median(rgb) if rgb.numel() >= MIN_SURFACE_RAYS else 0.0,
            "sdf_ray_gap": _median(sdf),
            "hit_flip_share": float((hit_p != hit_r).double().mean()),
            "point_ray_gap": _median(pts),
            "surface_rays": float(both.sum())}


TERMS = {"loss": "loss_gap", "rgb_loss": "rgb_gap", "eikonal_loss": "eikonal_gap",
         "mask_loss": "mask_gap"}


def gaps(prog: Dict, ref: Dict, init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [each step's loss terms], "grad1":
    {leaf: tensor}, "params": {leaf: tensor after the last step}, "rays1":
    the first step's per-ray outputs}, ``ref`` also "grad_norms", each
    step's gradient norm by leaf; ``init`` the weights both started from."""
    p1, r1 = prog["losses"][0]["loss"], ref["losses"][0]["loss"]
    out = {"loss1_gap": abs(p1 - r1) / abs(r1) if math.isfinite(p1) else math.inf}
    for term, name in TERMS.items():
        pairs = [(p[term], r[term]) for p, r in zip(prog["losses"], ref["losses"])]
        gap = max(abs(p - r) / abs(r) if r else abs(p - r) for p, r in pairs)
        out[name] = gap if all(math.isfinite(p) for p, _ in pairs) else math.inf
    leaves = sorted(set(prog["grad1"]) & set(ref["grad1"]))
    g_ref = _norms({k: ref["grad1"][k] for k in leaves})
    g_prog = _norms({k: prog["grad1"][k] for k in leaves})
    moving = set()
    for norms in ref["grad_norms"]:
        floor = statistics.median(norms.values())
        moving |= {k for k, v in norms.items() if v > 0 and v >= IGNORED_GRAD_SHARE * floor}
    moving = sorted(moving & set(prog["params"]))
    d_ref = _norms({k: ref["params"][k].to(init[k].device) - init[k] for k in moving})
    d_prog = _norms({k: prog["params"][k].to(init[k].device) - init[k] for k in moving})
    out["grad_gap"], out["grad_leaf"], out["grad_leaf_own"] = _widest(g_prog, g_ref)
    out["change_gap"], out["change_leaf"], out["change_leaf_own"] = _widest(d_prog, d_ref)
    if "rays1" in prog and "rays1" in ref:
        out.update(ray_gaps(prog["rays1"], ref["rays1"]))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or under it; a cell with no limits
    is not correct."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())
