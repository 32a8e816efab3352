"""COLMAP sparse reconstruction -> cameras.npz in the repo convention.

A copy of ``hashmodnffbanks_idr_tpu/data/colmap/gen_cameras.py``, the
counterpart of the reference pipeline
(data/preprocess_custom_data_colmap_Neus/colmap_preprocess/{pose_utils,
gen_cameras}.py): per-image P = K [R|t] from the sparse model, plus a
scale_mat normalizing the (optionally cleaned) point cloud into the unit
sphere (DATA_CONVENTION.md contract).

    python -m hashmodnffbanks_idr_tpu_torch.data.colmap.gen_cameras \
        --sparse_dir <scene>/sparse/0 --out <scene>/cameras.npz \
        [--points_ply cleaned.ply]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .read_model import read_model


def colmap_to_cameras_npz(sparse_dir: str, out_path: str,
                          points_ply: str | None = None,
                          percentile: float = 99.0) -> str:
    cams, imgs, pts = read_model(sparse_dir)

    if points_ply:
        from ...utils.ply import read_ply

        pts, _ = read_ply(points_ply)

    # normalization: center + radius covering `percentile`% of points
    if len(pts):
        center = np.median(pts, axis=0)
        r = np.percentile(np.linalg.norm(pts - center, axis=-1), percentile) * 1.1
    else:
        center = np.zeros(3)
        r = 1.0
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= r
    scale_mat[:3, 3] = center

    out = {}
    ordered = sorted(imgs.values(), key=lambda im: im.name)
    for i, im in enumerate(ordered):
        K = cams[im.camera_id].K()
        Rt = np.concatenate([im.R(), im.tvec[:, None]], axis=1)
        wm = np.eye(4)
        wm[:3, :4] = K @ Rt
        out[f"world_mat_{i}"] = wm
        out[f"scale_mat_{i}"] = scale_mat
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)
    print(f"wrote {out_path}: {len(ordered)} cameras, "
          f"center={center.round(3)}, radius={r:.3f}")
    return out_path


def run_colmap(scene_dir: str, colmap_bin: str = "colmap",
               matcher: str = "exhaustive_matcher") -> str:
    """Structure from motion (colmap_wrapper.py role): runs a ``colmap`` binary's
    feature extraction, matching and mapping; returns the sparse model's
    directory."""
    import subprocess

    db = os.path.join(scene_dir, "database.db")
    sparse = os.path.join(scene_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    for cmd in (
        [colmap_bin, "feature_extractor", "--database_path", db,
         "--image_path", os.path.join(scene_dir, "images"),
         "--ImageReader.single_camera", "1"],
        [colmap_bin, matcher, "--database_path", db],
        [colmap_bin, "mapper", "--database_path", db,
         "--image_path", os.path.join(scene_dir, "images"),
         "--output_path", sparse],
    ):
        subprocess.run(cmd, check=True)
    return os.path.join(sparse, "0")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sparse_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--points_ply", default=None)
    p.add_argument("--percentile", type=float, default=99.0)
    args = p.parse_args(argv)
    colmap_to_cameras_npz(args.sparse_dir, args.out, args.points_ply, args.percentile)


if __name__ == "__main__":
    main()
