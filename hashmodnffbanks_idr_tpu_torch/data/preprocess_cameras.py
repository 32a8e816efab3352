"""Camera normalization: compute scale_mat so the object fits the unit
sphere.

Counterpart of ``hashmodnffbanks_idr_tpu/data/preprocess_cameras.py``
(code/preprocess_cameras.py:10-239 of the reference), with the same two
stages:

  * ``epipolar``: for sampled silhouette points of view 0, transfer to every
    5th view via the fundamental matrix, keep silhouette points within 0.7
    px of the epipolar line, triangulate (DLT), intersect the per-view
    depth intervals and collect the 3D points at the bounds; centroid =
    mean, scale = std.  A numpy copy of the JAX module's (:42-135).
  * ``hull``: voxel carves against every mask, ``refine_visual_hull``
    (seeded by the epipolar bounds) and ``visual_hull_scale`` (a fixed
    grid).  These vote a million voxels in every view, the part worth the
    card: they run in torch on ``device`` (None -> the CUDA card), in
    float64 so that ``proj / z`` rounds as numpy's does and the votes are
    the JAX module's.

The default pipeline is the reference's: epipolar bounds, then the visual
hull refined from them.  Writes ``cameras_new.npz`` (or
``cameras_linear_init_new.npz``) beside the input.  Masks are read by the
port's PNG reader (``scene_dataset.load_mask``).

CLI:
    python -m hashmodnffbanks_idr_tpu_torch.data.preprocess_cameras \
        --source_dir <dir with mask/ cameras.npz> \
        [--method epipolar+hull|epipolar|hull] [--grid 100] [--platform cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import resolve_device
from .scene_dataset import glob_imgs, load_mask


# ---------------------------------------------------------------------------
# epipolar depth-bounds branch (code/preprocess_cameras.py:21-64,121-166)
# ---------------------------------------------------------------------------

def _camera_center(P: np.ndarray) -> np.ndarray:
    """Homogeneous null vector of P (the camera center), (4,)."""
    return np.linalg.svd(P)[-1][-1, :]


def fundamental_matrix(P1: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """F with l1 = F @ x2: maps points in P2's image to epipolar lines in
    P1's image (code/preprocess_cameras.py:21-35)."""
    C2 = _camera_center(P2)
    e = P1 @ C2  # epipole of camera 2 in image 1
    e_cross = np.array([
        [0.0, -e[2], e[1]],
        [e[2], 0.0, -e[0]],
        [-e[1], e[0], 0.0],
    ])
    return e_cross @ P1 @ np.linalg.pinv(P2)


def _triangulate_dlt(P0, Pj, x0, pts_j):
    """DLT triangulation of one view-0 pixel x0 (2,) against many view-j
    pixels pts_j (2, N) — the cv2.triangulatePoints formulation.  Returns
    homogeneous (N, 4)."""
    n = pts_j.shape[1]
    A = np.empty((n, 4, 4))
    A[:, 0] = x0[0] * P0[2] - P0[0]
    A[:, 1] = x0[1] * P0[2] - P0[1]
    A[:, 2] = pts_j[0, :, None] * Pj[2] - Pj[0]
    A[:, 3] = pts_j[1, :, None] * Pj[2] - Pj[1]
    return np.linalg.svd(A)[-1][:, -1, :]  # (N, 4)


def _min_max_depth(curx, cury, P_j, sil_j, P_0, F_j0, dist_thresh=0.7):
    """Min/max possible view-0 depth of pixel (curx, cury) given view j's
    silhouette (code/preprocess_cameras.py:41-64)."""
    line = F_j0 @ np.array([curx, cury, 1.0])
    line = line / np.linalg.norm(line[:2])
    dists = np.abs(sil_j.T @ line)
    matching = sil_j[:, dists < dist_thresh]
    if matching.shape[1] == 0:
        return 0.0, 0.0
    X = _triangulate_dlt(P_0, P_j, np.array([curx, cury]), matching[:2, :])
    w = X[:, 3]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    depths = (X / w[:, None]) @ P_0[2]
    depths = depths[depths >= 0]
    if depths.shape[0] == 0:
        return 0.0, 0.0
    return float(depths.min()), float(depths.max())


def epipolar_depth_bounds(Ps, mask_points_all, n_points=100, view_stride=5,
                          seed=0):
    """The reference's get_normalization_function core
    (code/preprocess_cameras.py:121-166): intersect per-view epipolar depth
    intervals for sampled view-0 silhouette points; return (centroid (3,),
    scale, all_Xs (M, 3))."""
    P_0 = Ps[0]
    Fs = [fundamental_matrix(Ps[j], P_0) for j in range(len(Ps))]
    C0 = _camera_center(P_0)
    C0 = C0 / C0[3]
    K0inv = np.linalg.inv(P_0[:3, :3])

    xs = mask_points_all[0][0, :]
    ys = mask_points_all[0][1, :]
    rng = np.random.default_rng(seed)
    inds = rng.permutation(xs.shape[0])[:n_points]

    all_Xs = []
    for i in inds:
        curx, cury = xs[i], ys[i]
        observed_in_all = True
        max_d_all, min_d_all = 1e10, 1e-10
        for j in range(1, len(Ps), view_stride):
            min_d, max_d = _min_max_depth(curx, cury, Ps[j],
                                          mask_points_all[j], P_0, Fs[j])
            if abs(min_d) < 1e-5:
                observed_in_all = False
                break
            max_d_all = min(max_d_all, max_d)
            min_d_all = max(min_d_all, min_d)
            if max_d_all < min_d_all + 1e-2:
                observed_in_all = False
                break
        if observed_in_all:
            direction = K0inv @ np.array([curx, cury, 1.0])
            all_Xs.append(C0[:3] + direction * min_d_all)
            all_Xs.append(C0[:3] + direction * max_d_all)

    if not all_Xs:
        raise RuntimeError("epipolar normalization found no commonly-observed "
                           "silhouette points — check masks/cameras")
    all_Xs = np.array(all_Xs)
    return all_Xs.mean(axis=0), float(all_Xs.std()), all_Xs


def mask_points(masks: np.ndarray):
    """(V, H, W) bool -> list of (3, Ni) homogeneous silhouette pixels
    (code/preprocess_cameras.py:74-86)."""
    out = []
    for m in masks:
        ys, xs = np.where(m)
        out.append(np.stack([xs, ys, np.ones_like(xs)]).astype(np.float64))
    return out


# ---------------------------------------------------------------------------
# the voxel carves, on the device
# ---------------------------------------------------------------------------

def _safe_z(z: torch.Tensor, tiny: float) -> torch.Tensor:
    return torch.where(z.abs() < tiny, torch.full_like(z, tiny), z)


def refine_votes(masks: np.ndarray, Ps: np.ndarray, scale: float, center: np.ndarray,
                 grid: int = 100, device=None):
    """The carve of ``refine_visual_hull``: a ``grid``^3 lattice spanning
    center +- scale (numpy's ``meshgrid`` order), each voxel's count of
    views whose mask holds its rounded projection.  Returns (points (3, G),
    votes (G,) int32), float64 / int32 tensors on ``device``."""
    device = resolve_device(device)
    V, H, W = masks.shape
    axs = torch.from_numpy(np.linspace(-scale, scale, grid)).to(device)
    X, Y, Z = torch.meshgrid(axs, axs, axs, indexing="xy")
    pts = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)]) + torch.as_tensor(
        np.asarray(center, np.float64), device=device)[:, None]
    pts_h = torch.cat([pts, torch.ones_like(pts[:1])], dim=0)
    masks_d = torch.as_tensor(masks, dtype=torch.bool, device=device)
    Ps_d = torch.as_tensor(np.asarray(Ps, np.float64), device=device)
    votes = torch.zeros(pts.shape[1], dtype=torch.int32, device=device)
    for i in range(V):
        proj = Ps_d[i] @ pts_h
        z = proj[2]
        # clamped before the integer cast (out of the image either way)
        xy = torch.round(proj[:2] / _safe_z(z, 1e-12)).clamp(-1, max(H, W)).to(torch.int64)
        ok = (xy[0] >= 0) & (xy[0] < W) & (xy[1] >= 0) & (xy[1] < H) & (z > 0)
        inside = masks_d[i][xy[1].clamp(0, H - 1), xy[0].clamp(0, W - 1)]
        votes += (ok & inside).to(torch.int32)
    return pts, votes


def refine_visual_hull(masks, Ps, scale, center, grid=100, minimal_views=45, device=None):
    """Visual-hull refinement seeded by (center, scale)
    (code/preprocess_cameras.py:88-118): keep the voxels of ``refine_votes``
    seen inside >= minimal_views masks; return (centroid, 3 x mean voxel
    norm)."""
    V = masks.shape[0]
    minimal_views = min(minimal_views, max(1, int(0.9 * V)))
    pts, votes = refine_votes(masks, Ps, scale, center, grid=grid, device=device)
    final = pts[:, votes >= minimal_views]
    if final.shape[1] == 0:
        raise RuntimeError("visual hull empty after refinement — masks/cameras "
                           "inconsistent or minimal_views too strict")
    centroid = final.mean(dim=1)
    rel = final - centroid[:, None]
    scale_out = torch.sqrt((rel ** 2).sum(dim=0)).mean() * 3.0
    return centroid.cpu().numpy(), float(scale_out)


def hull_votes(masks: np.ndarray, Ps: np.ndarray, grid: int = 100, extent: float = 6.0,
               device=None):
    """The carve of ``visual_hull_scale``: a ``grid``^3 lattice over
    [-extent, extent]^3 (``ij`` order), each voxel's count of views whose
    mask holds its projection's pixel.  Returns (points (G, 3), votes (G,)
    int32), float64 / int32 tensors on ``device``."""
    device = resolve_device(device)
    V, H, W = masks.shape
    axs = torch.from_numpy(np.linspace(-extent, extent, grid)).to(device)
    X, Y, Z = torch.meshgrid(axs, axs, axs, indexing="ij")
    pts = torch.stack([X, Y, Z, torch.ones_like(X)], dim=-1).reshape(-1, 4)
    masks_d = torch.as_tensor(masks, dtype=torch.bool, device=device)
    Ps_d = torch.as_tensor(np.asarray(Ps, np.float64), device=device)
    votes = torch.zeros(pts.shape[0], dtype=torch.int32, device=device)
    for v in range(V):
        proj = pts @ Ps_d[v].T  # (G, 3)
        z = proj[:, 2]
        zs = _safe_z(z, 1e-9)
        x, y = proj[:, 0] / zs, proj[:, 1] / zs
        inside = (z > 0) & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
        # out-of-image x, y are masked by ``inside``; clamp them before the
        # integer cast so that no value overflows it
        xi = x.clamp(-1, W).to(torch.int64).clamp(0, W - 1)
        yi = y.clamp(-1, H).to(torch.int64).clamp(0, H - 1)
        votes += (inside & masks_d[v, yi, xi]).to(torch.int32)
    return pts[:, :3], votes


def visual_hull_scale(masks: np.ndarray, Ps: np.ndarray, img_res=None,
                      grid: int = 100, extent: float = 6.0,
                      min_views_frac: float = 1.0, device=None):
    """masks: (V, H, W) bool; Ps: (V, 3, 4) projection matrices.

    Returns (center (3,), radius float) of the visual hull of
    ``hull_votes``: the voxels every view sees inside its mask (or, when
    none does, a majority)."""
    V = masks.shape[0]
    pts, votes = hull_votes(masks, Ps, grid=grid, extent=extent, device=device)
    need = int(np.ceil(min_views_frac * V))
    hull = pts[votes >= need]
    if len(hull) == 0:  # relax: majority of views
        hull = pts[votes >= max(V // 2, 1)]
    if len(hull) == 0:
        raise RuntimeError("visual hull empty — check masks/cameras")
    center = hull.mean(dim=0)
    radius = torch.linalg.vector_norm(hull - center, dim=-1).max() * 1.1
    return center.cpu().numpy(), float(radius)


def get_normalization(masks: np.ndarray, Ps: np.ndarray,
                      method: str = "epipolar+hull", grid: int = 100,
                      n_points: int = 100, seed: int = 0, device=None):
    """Compute (center (3,), scale float) by the chosen method.

    ``epipolar+hull`` is the reference's exact pipeline
    (code/preprocess_cameras.py:121-168): epipolar depth bounds -> visual
    hull refinement seeded by them.
    """
    if method == "hull":
        return visual_hull_scale(masks, Ps, masks.shape[1:], grid=grid, device=device)
    center, scale, _ = epipolar_depth_bounds(Ps, mask_points(masks),
                                             n_points=n_points, seed=seed)
    if method == "epipolar":
        return center, scale
    if method != "epipolar+hull":
        raise ValueError(f"method={method!r}")
    return refine_visual_hull(masks, Ps, scale, center, grid=grid, device=device)


def compute_scale_mats(source_dir: str, grid: int = 100,
                       use_linear_init: bool = False,
                       method: str = "epipolar+hull", device=None) -> str:
    cam_name = "cameras_linear_init.npz" if use_linear_init else "cameras.npz"
    cam_path = os.path.join(source_dir, cam_name)
    cameras = dict(np.load(cam_path))
    mask_paths = glob_imgs(os.path.join(source_dir, "mask"))
    masks = np.stack([load_mask(p) for p in mask_paths])
    V = len(mask_paths)
    Ps = np.stack([cameras[f"world_mat_{i}"][:3, :4].astype(np.float64)
                   for i in range(V)])

    n_points = 1000 if use_linear_init else 100  # preprocess_cameras.py:185-191
    center, radius = get_normalization(masks, Ps, method=method, grid=grid,
                                       n_points=n_points, device=device)

    scale_mat = np.eye(4, dtype=np.float64)
    scale_mat[:3, :3] *= radius
    scale_mat[:3, 3] = center

    out = {}
    for i in range(V):
        out[f"world_mat_{i}"] = cameras[f"world_mat_{i}"]
        out[f"scale_mat_{i}"] = scale_mat
    out_path = os.path.join(source_dir, cam_name.replace(".npz", "_new.npz"))
    np.savez(out_path, **out)
    print(f"wrote {out_path} (method={method}, center={center.round(3)}, "
          f"scale={radius:.3f})")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source_dir", required=True)
    p.add_argument("--grid", type=int, default=100)
    p.add_argument("--use_linear_init", action="store_true")
    p.add_argument("--method", default="epipolar+hull",
                   choices=["epipolar+hull", "epipolar", "hull"])
    p.add_argument("--platform", default=None,
                   help="torch device of the voxel carves (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)
    return compute_scale_mats(args.source_dir, args.grid, args.use_linear_init,
                              method=args.method, device=args.platform)


if __name__ == "__main__":
    main(sys.argv[1:])
