"""Evaluation: mesh export + per-view rendering metrics (PSNR/SSIM/LPIPS).

Counterpart of ``hashmodnffbanks_idr_tpu/eval/evaluator.py``
(code/evaluation/eval.py:17-304 of the reference):
  * mesh: high-res two-pass surface extraction of the plain float32 SDF,
    transformed to world coordinates by scale_mat, largest component,
    exported as surface_world_coordinates_{epoch}.ply (eval.py:108-123);
  * rendering: every train view re-rendered with ``training=False`` in
    32,768-ray tiles on the model's device, masked PSNR + SSIM + LPIPS per
    view written to CSVs under evals/<exp>/metrics/ (eval.py:132-205);
  * cameras: ``camera_alignment``, a copy of the JAX package's Procrustes
    rotation + least-squares scale/translation (eval.py:208-251).

The render runs under ``torch.no_grad()``; only the normals' SDF gradient
records a graph, freed with each tile.  Each tile's outputs stay on the
device and a view is read back once.  The tracer's sweep draws come from a
generator seeded 0 for every tile, as the JAX package's fixed key.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config.hocon import Config
from ..data.image_io import write_png
from ..data.scene_dataset import SceneDataset
from ..models.lpips import weights_source
from ..models.metrics import lpips_or_none, masked_psnr, ssim
from ..models.renderer import IDRNetwork
from ..utils.chunking import render_in_tiles
from ..utils.ply import write_ply
from .surface import get_surface_high_res_mesh


TILE = 32768  # rays a render call (the JAX package's eval tile)


class Evaluator:
    """Renders and meshes ``model`` (an ``IDRNetwork``, on its own device).
    With a ``pose_vecs`` table ((V, 7) quaternion + translation, any
    device) view ``idx`` renders from ``pose_vecs[idx]`` instead of the
    dataset's pose (JAX :37-45, :70-73)."""

    def __init__(self, conf: Config, model: IDRNetwork, data_root: Optional[str] = None,
                 scan_id: int = -1, dataset: Optional[SceneDataset] = None,
                 pose_vecs=None):
        self.model = model
        self.device = next(model.parameters()).device
        self.pose_vecs = pose_vecs

        if dataset is not None:
            self.dataset = dataset
        else:
            dataset_conf = dict(conf.get_config("dataset").data)
            if scan_id != -1:
                dataset_conf["scan_id"] = scan_id
            self.dataset = SceneDataset(False, data_root=data_root, **dataset_conf)

    def render_pixels(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The eval forward over one full image's ``uv``/``object_mask``
        with its ``intrinsics``/``pose`` -> ray-flattened numpy outputs."""
        inputs = {k: torch.as_tensor(sample[k], device=self.device)
                  for k in ("uv", "intrinsics", "pose", "object_mask")}

        @torch.no_grad()
        def render_tile(tile_inputs):
            gen = torch.Generator(device=self.device).manual_seed(0)
            out = self.model(tile_inputs, generator=gen, training=False)
            return {k: out[k] for k in ("rgb_values", "network_object_mask", "dists")}

        return render_in_tiles(render_tile, inputs, self.dataset.total_pixels, TILE)

    def render_view(self, idx: int) -> Dict[str, np.ndarray]:
        sample, gt = self.dataset.full_image_inputs(idx)
        if self.pose_vecs is not None:
            sample["pose"] = torch.as_tensor(self.pose_vecs)[idx:idx + 1].detach()
        out = self.render_pixels(sample)
        H, W = self.dataset.img_res
        return {
            "rgb": out["rgb_values"].reshape(H, W, 3),
            "mask": out["network_object_mask"].reshape(H, W),
            "dists": out["dists"].reshape(H, W),
            "gt_rgb": gt["rgb"].reshape(H, W, 3),
            "gt_mask": sample["object_mask"].reshape(H, W),
        }

    # -- mesh -------------------------------------------------------------
    def extract_mesh(self, resolution: int = 400, transform: Optional[np.ndarray] = None):
        verts, faces = get_surface_high_res_mesh(self.model.implicit_network.sdf,
                                                 resolution=resolution, device=self.device)
        if transform is None:
            transform = self.dataset.get_scale_mat()
        if len(verts):
            verts = verts @ transform[:3, :3].T + transform[:3, 3]
        return verts, faces

    def export_mesh(self, out_path: str, epoch: int = 0, resolution: int = 400,
                    transform: Optional[np.ndarray] = None):
        verts, faces = self.extract_mesh(resolution, transform)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_ply(out_path, verts, faces)
        return out_path

    # -- rendering metrics -------------------------------------------------
    def eval_rendering(self, out_dir: str, save_images: bool = True,
                       views=None) -> Dict[str, float]:
        os.makedirs(os.path.join(out_dir, "metrics"), exist_ok=True)
        if save_images:
            os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
        psnrs, ssims, lpipss = [], [], []
        view_ids = list(views) if views else list(range(len(self.dataset)))
        for idx in view_ids:
            view = self.render_view(idx)
            mask = view["gt_mask"]
            # reference metric convention (eval.py:164-185): images mapped to
            # [0,1] and MULTIPLIED by the object mask before every metric —
            # SSIM/LPIPS run on the masked images (metrics.py:26-55), PSNR's
            # MSE is renormalized by the mask count.
            m3 = mask[..., None].astype(np.float32)
            rgb01 = (view["rgb"] + 1.0) / 2.0 * m3
            gt01 = (view["gt_rgb"] + 1.0) / 2.0 * m3
            p = masked_psnr(rgb01, gt01, mask, data_range=1.0)
            s = ssim(rgb01, gt01, data_range=1.0)
            l = lpips_or_none(rgb01, gt01, device=self.device)
            psnrs.append(p)
            ssims.append(s)
            lpipss.append(l if l is not None else float("nan"))
            if save_images:
                self._save_view_png(os.path.join(out_dir, "renders", f"{idx:03d}.png"), view)
        for name, vals in [("psnrs", psnrs), ("ssims", ssims), ("lpips", lpipss)]:
            with open(os.path.join(out_dir, "metrics", f"{name}.csv"), "w", newline="") as f:
                w = csv.writer(f)
                for i, v in zip(view_ids, vals):
                    w.writerow([i, v])
        return {
            "psnr_mean": float(np.nanmean(psnrs)),
            "ssim_mean": float(np.nanmean(ssims)),
            "lpips_mean": float(np.nanmean(lpipss)),
            # 'official' or 'fallback' — fallback LPIPS values are not
            # comparable to published AlexNet-LPIPS numbers (models/lpips.py)
            "lpips_weights": weights_source(),
        }

    def _save_view_png(self, path: str, view):
        rgb = ((view["rgb"] + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        gt = ((view["gt_rgb"] + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        write_png(path, np.concatenate([rgb, gt], axis=1))


# ---------------------------------------------------------------------------
# camera accuracy (eval.py:208-251, cvxpy replaced by least squares)
# ---------------------------------------------------------------------------

def camera_alignment(pred_Rs: np.ndarray, gt_Rs: np.ndarray,
                     pred_ts: np.ndarray, gt_ts: np.ndarray):
    """Align predicted cameras to GT: Procrustes rotation (SVD) + similarity
    (scale, translation) by least squares; returns per-camera rotation errors
    (deg) and translation errors after alignment."""
    # rotation alignment: find Q minimizing sum ||pred_R_i Q - gt_R_i||
    M = sum(p.T @ g for p, g in zip(pred_Rs, gt_Rs))
    U, _, Vt = np.linalg.svd(M)
    Q = U @ Vt
    if np.linalg.det(Q) < 0:
        U[:, -1] *= -1
        Q = U @ Vt
    rot_errs = []
    for p, g in zip(pred_Rs, gt_Rs):
        dR = (p @ Q).T @ g
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        rot_errs.append(ang)

    # similarity on camera centers: gt ~ s * (pred @ Q') + t
    pred_c = pred_ts @ Q
    # solve per-axis scale+shift jointly: gt = s*pred + t (shared s, per-axis t)
    n = len(pred_c)
    X = np.zeros((3 * n, 4))
    y = gt_ts.reshape(-1)
    for ax in range(3):
        X[ax::3, 0] = pred_c[:, ax]
        X[ax::3, 1 + ax] = 1.0
    sol, *_ = np.linalg.lstsq(X, y, rcond=None)
    s, t = sol[0], sol[1:]
    aligned = s * pred_c + t
    t_errs = np.linalg.norm(aligned - gt_ts, axis=-1)
    return {
        "rot_err_mean": float(np.mean(rot_errs)),
        "rot_err_median": float(np.median(rot_errs)),
        "t_err_mean": float(np.mean(t_errs)),
        "t_err_median": float(np.median(t_errs)),
        "rotation": Q, "scale": float(s), "translation": t,
    }
