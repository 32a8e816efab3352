"""DTU Chamfer harness: mesh vs ground-truth point cloud.

Role-parity with code/evaluation/dtu_eval/dtu_eval.py:29-184 (DTUeval-python):
sample the candidate mesh to a point cloud, downsample at `downsample_density`
(0.19 ~ the reference's thinning radius), apply the DTU ObsMask / bounding box
/ ground plane when the official .mat files are present, then two-sided kd-tree
nearest-neighbour means (d2s, s2d, overall).  Without the DTU auxiliaries it
degrades gracefully to plain two-sided Chamfer.

Output format matches the reference's log.txt: ``mean_d2s mean_s2d over_all``.

A copy of ``hashmodnffbanks_idr_tpu/eval/dtu_chamfer.py`` (numpy + scipy).

    python -m hashmodnffbanks_idr_tpu_torch.eval.dtu_chamfer --data mesh.ply \
        --gt data/dtu_shaped_small/scan0/gt_mesh.ply --downsample_density 0.005
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray,
                        n_samples: int = 1_000_000, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform sampling of triangle surface."""
    if len(faces) == 0:
        return verts
    rng = np.random.default_rng(seed)
    tri = verts[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    if area.sum() == 0:
        return verts
    probs = area / area.sum()
    idx = rng.choice(len(faces), size=n_samples, p=probs)
    u = rng.random((n_samples, 1))
    v = rng.random((n_samples, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[idx]
    return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])


def downsample(points: np.ndarray, radius: float = 0.19) -> np.ndarray:
    """Poisson-disk-style thinning via voxel hashing (dtu_eval.py's 0.19
    downsample_density role)."""
    if radius <= 0:
        return points
    keys = np.floor(points / radius).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(first)]


def apply_obs_mask(points: np.ndarray, mask_path: str, patch: int = 60):
    """Filter points by the official DTU ObsMask volume (.mat)."""
    from scipy.io import loadmat

    m = loadmat(mask_path)
    bb = m["BB"].astype(np.float64)
    res = float(m["Res"])
    obs = m["ObsMask"]
    margin = patch
    keep = np.all(points >= bb[0] - margin, axis=-1) & np.all(points <= bb[1] + margin, axis=-1)
    pts = points[keep]
    idx = np.floor((pts - bb[0]) / res).astype(np.int64)
    valid = np.all(idx >= 0, axis=-1) & np.all(idx < np.array(obs.shape), axis=-1)
    inside = np.zeros(len(pts), dtype=bool)
    ii = idx[valid]
    inside[valid] = obs[ii[:, 0], ii[:, 1], ii[:, 2]] > 0
    return pts[inside]


def apply_ground_plane(points: np.ndarray, plane_path: str):
    from scipy.io import loadmat

    P = loadmat(plane_path)["P"]
    hom = np.concatenate([points, np.ones((len(points), 1))], axis=-1)
    above = (hom @ P.reshape(4, 1))[:, 0] > 0
    return points[above]


def dtu_chamfer(
    mesh_verts: np.ndarray,
    mesh_faces: np.ndarray,
    gt_points: np.ndarray,
    downsample_density: float = 0.19,
    obs_mask_path: Optional[str] = None,
    ground_plane_path: Optional[str] = None,
    max_dist: float = 20.0,
):
    from scipy.spatial import cKDTree

    pts = sample_mesh_surface(mesh_verts, mesh_faces)
    pts = downsample(pts, downsample_density)
    gt = downsample(gt_points, downsample_density)
    if obs_mask_path and os.path.exists(obs_mask_path):
        pts = apply_obs_mask(pts, obs_mask_path)
    if ground_plane_path and os.path.exists(ground_plane_path):
        gt = apply_ground_plane(gt, ground_plane_path)

    d2s = cKDTree(gt).query(pts, k=1)[0]
    s2d = cKDTree(pts).query(gt, k=1)[0]
    d2s = np.minimum(d2s, max_dist)
    s2d = np.minimum(s2d, max_dist)
    return {
        "mean_d2s": float(d2s.mean()),
        "mean_s2d": float(s2d.mean()),
        "over_all": float((d2s.mean() + s2d.mean()) / 2),
    }


def main(argv=None):
    from ..utils.ply import read_ply

    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="candidate mesh .ply")
    p.add_argument("--gt", required=True, help="ground-truth .ply point cloud/mesh")
    p.add_argument("--scan", type=int, default=-1)
    p.add_argument("--dataset_dir", default=None,
                   help="DTU aux dir with ObsMask{scan}_10.mat / Plane{scan}.mat")
    p.add_argument("--downsample_density", type=float, default=0.19)
    p.add_argument("--log", default=None)
    args = p.parse_args(argv)

    verts, faces = read_ply(args.data)
    gt_verts, _ = read_ply(args.gt)
    obs = plane = None
    if args.dataset_dir and args.scan >= 0:
        obs = os.path.join(args.dataset_dir, f"ObsMask{args.scan}_10.mat")
        plane = os.path.join(args.dataset_dir, f"Plane{args.scan}.mat")
    res = dtu_chamfer(verts, faces, gt_verts,
                      downsample_density=args.downsample_density,
                      obs_mask_path=obs, ground_plane_path=plane)
    line = f"{res['mean_d2s']} {res['mean_s2d']} {res['over_all']}"
    print(line)
    if args.log:
        with open(args.log, "a") as f:
            f.write(json.dumps({"data": args.data, **res}) + "\n")


if __name__ == "__main__":
    main()
