"""Scene dataset: multi-view masked images + cameras.npz.

Counterpart of ``hashmodnffbanks_idr_tpu/data/scene_dataset.py``: the same
directory layout (``<root>/<data_dir>/scan<id>/{image,mask}/*.png`` and
``cameras.npz``), file order, mask threshold and camera decomposition
(P = world_mat @ scale_mat, intrinsics and pose by RQ decomposition,
scene_dataset.py:46-51).  Images are decoded by ``image_io`` (numpy + zlib,
no OpenCV), the views in parallel (``native_loader``, JAX :94-100).  All
pixels go to the device once (RGB as uint8) and the train step gathers its
pixels there.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..geometry.cameras import decompose_projection, rot_to_quat, uv_grid
from .native_loader import load_mask, load_scene_native  # noqa: F401 (load_mask re-exported)


def glob_imgs(path: str):
    imgs = []
    for ext in ["*.png", "*.jpg", "*.JPEG", "*.JPG"]:
        imgs.extend(glob(os.path.join(path, ext)))
    return sorted(imgs)


def rgb_to_pm1(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] float32 (rend_util.py:8-16)."""
    return (rgb_uint8.to(torch.float32) / 255.0 - 0.5) * 2.0


class SceneDataset:
    """Loads a scan directory: image/, mask/, cameras.npz."""

    def __init__(
        self,
        train_cameras: bool,
        data_dir: str,
        img_res,
        scan_id: int = 0,
        cam_file: Optional[str] = None,
        data_root: Optional[str] = None,
    ):
        root = data_root or os.environ.get("HMNFFB_DATA_ROOT", "data")
        self.instance_dir = os.path.join(root, data_dir, f"scan{scan_id}")
        if not os.path.isdir(self.instance_dir):
            raise FileNotFoundError(f"no scan directory {self.instance_dir}")

        self.img_res = tuple(img_res)
        self.total_pixels = img_res[0] * img_res[1]
        self.train_cameras = train_cameras

        image_paths = glob_imgs(os.path.join(self.instance_dir, "image"))
        mask_paths = glob_imgs(os.path.join(self.instance_dir, "mask"))
        if not image_paths or len(mask_paths) != len(image_paths):
            raise FileNotFoundError(
                f"{self.instance_dir}: {len(image_paths)} images and "
                f"{len(mask_paths)} masks; expected the same non-zero number")
        self.n_images = len(image_paths)

        self.cam_file = os.path.join(self.instance_dir, cam_file or "cameras.npz")
        camera_dict = np.load(self.cam_file)
        scale_mats = [camera_dict[f"scale_mat_{i}"].astype(np.float32) for i in range(self.n_images)]
        world_mats = [camera_dict[f"world_mat_{i}"].astype(np.float32) for i in range(self.n_images)]

        intr, poses = [], []
        for scale_mat, world_mat in zip(scale_mats, world_mats):
            P = (world_mat @ scale_mat)[:3, :4]
            intrinsics, pose = decompose_projection(P)
            intr.append(intrinsics)
            poses.append(pose)
        self.intrinsics_all = np.stack(intr).astype(np.float32)  # (V, 4, 4)
        self.pose_all = np.stack(poses).astype(np.float32)       # (V, 4, 4)

        # (V, H*W, 3) uint8 and (V, H*W) bool
        self.rgb_images, self.object_masks = load_scene_native(image_paths, mask_paths,
                                                               self.img_res)

        self.uv = uv_grid(self.img_res)  # (H*W, 2) float32

    def __len__(self):
        return self.n_images

    # -- full-image access (plot / eval path) -----------------------------
    def full_image_inputs(self, idx: int):
        sample = {
            "object_mask": self.object_masks[idx][None],
            "uv": self.uv[None],
            "intrinsics": self.intrinsics_all[idx][None],
            "pose": self.pose_all[idx][None],
        }
        ground_truth = {"rgb": rgb_to_pm1(torch.from_numpy(self.rgb_images[idx])).numpy()[None]}
        return sample, ground_truth

    # -- camera initializations -------------------------------------------
    def get_scale_mat(self):
        return np.load(self.cam_file)["scale_mat_0"]

    def get_gt_pose(self, scaled: bool = False):
        camera_dict = np.load(self.cam_file)
        poses = []
        for i in range(self.n_images):
            P = camera_dict[f"world_mat_{i}"].astype(np.float32)
            if scaled:
                P = P @ camera_dict[f"scale_mat_{i}"].astype(np.float32)
            _, pose = decompose_projection(P[:3, :4])
            poses.append(pose)
        return np.stack(poses)

    def get_pose_init(self) -> np.ndarray:
        """Noisy linear-init poses as (V, 7) quaternion+translation
        (scene_dataset.py:139-156)."""
        cam_file = os.path.join(self.instance_dir, "cameras_linear_init.npz")
        camera_dict = np.load(cam_file)
        poses = []
        for i in range(self.n_images):
            P = (
                camera_dict[f"world_mat_{i}"].astype(np.float32)
                @ camera_dict[f"scale_mat_{i}"].astype(np.float32)
            )[:3, :4]
            _, pose = decompose_projection(P)
            poses.append(pose)
        poses = np.stack(poses)
        quat = rot_to_quat(poses[:, :3, :3])
        return np.concatenate([quat, poses[:, :3, 3]], axis=1).astype(np.float32)

    # -- device-resident tensors for the train step -----------------------
    def device_arrays(self, device=None) -> Dict[str, torch.Tensor]:
        """Everything the train step gathers from, as tensors on ``device``
        (None -> the CUDA card); RGB stays uint8."""
        device = resolve_device(device)
        arrays = {
            "rgb": self.rgb_images,             # (V, HW, 3) uint8
            "mask": self.object_masks,          # (V, HW) bool
            "uv": self.uv,                      # (HW, 2) f32
            "intrinsics": self.intrinsics_all,  # (V, 4, 4)
            "pose": self.pose_all,              # (V, 4, 4)
        }
        return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
