"""Camera geometry: load-time projection decomposition, ray generation and
the bounding-sphere intersection.

Counterpart of ``hashmodnffbanks_idr_tpu/geometry/cameras.py``.  The numpy
helpers ``decompose_projection``, ``load_K_Rt_from_P`` and ``rot_to_quat``
are copies of the JAX module's (:28-98); ``quat_to_rot``, ``pose7_to_matrix``
and ``get_depth`` are its torch counterparts.  A pose is a (B, 4, 4)
cam-to-world matrix or, for trainable cameras, a (B, 7) quaternion (wxyz) +
translation vector; gradients reach the pose-7 vector through
``quat_to_rot``.
"""

from __future__ import annotations

import numpy as np
import torch


def decompose_projection(P: np.ndarray):
    """Decompose a 3x4 projection P = K [R | t] into intrinsics and c2w pose.

    Matches cv2.decomposeProjectionMatrix semantics as used by the reference
    (rend_util.py:25-46): returns (intrinsics 4x4, pose 4x4) where pose is the
    camera-to-world transform and K is normalized so K[2,2] == 1 with positive
    focal lengths.
    """
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    # RQ decomposition of M: M = K R with K upper-triangular.
    # Use QR of the reversed/transposed matrix.
    rev = np.eye(3)[::-1]
    Q, U = np.linalg.qr((rev @ M).T)
    K = rev @ U.T @ rev
    R = rev @ Q.T
    # Fix signs so diag(K) > 0 (S is its own inverse, so K S S R = K R = M).
    s = np.sign(np.diag(K))
    s[s == 0] = 1.0
    S = np.diag(s)
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:
        R = -R  # cv2 convention: rotation proper; K R = -M, scale washes out
    K = K / K[2, 2]
    # camera center: P c = 0 (homogeneous)
    _, _, Vt = np.linalg.svd(np.concatenate([P, [[0, 0, 0, 1]]], axis=0)[:3])
    c = Vt[-1]
    c = c[:3] / c[3]

    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K.astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)  # cam-to-world rotation
    pose[:3, 3] = c.astype(np.float32)
    return intrinsics, pose


def load_K_Rt_from_P(P: np.ndarray):
    """Alias keeping the reference's name (rend_util.py:25)."""
    return decompose_projection(P)


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(B,3,3) -> (B,4) wxyz. NumPy, load-time only (rend_util.py:121-139)."""
    R = np.asarray(R)
    q = np.ones(R.shape[:-2] + (4,), dtype=R.dtype)
    q[..., 0] = np.sqrt(np.maximum(1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], 1e-12)) / 2
    q[..., 1] = (R[..., 2, 1] - R[..., 1, 2]) / (4 * q[..., 0])
    q[..., 2] = (R[..., 0, 2] - R[..., 2, 0]) / (4 * q[..., 0])
    q[..., 3] = (R[..., 1, 0] - R[..., 0, 1]) / (4 * q[..., 0])
    return q


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(B,4) wxyz quaternion, normalised here -> (B,3,3). rend_util.py:102-119."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (qj**2 + qk**2), 2 * (qj * qi - qk * qr), 2 * (qi * qk + qr * qj),
            2 * (qj * qi + qk * qr), 1 - 2 * (qi**2 + qk**2), 2 * (qj * qk - qi * qr),
            2 * (qk * qi - qj * qr), 2 * (qj * qk + qi * qr), 1 - 2 * (qi**2 + qj**2),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def pose7_to_matrix(pose7: torch.Tensor) -> torch.Tensor:
    """(B,7) quaternion+translation -> (B,4,4) cam-to-world matrix."""
    B = pose7.shape[0]
    R = quat_to_rot(pose7[:, :4])
    top = torch.cat([R, pose7[:, 4:, None]], dim=-1)  # (B,3,4)
    # built on the device: a host tensor copied in would be a host read (and
    # a copy a captured CUDA graph cannot replay)
    bottom = pose7.new_zeros((B, 1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=1)


def _is_pose7(pose: torch.Tensor) -> bool:
    return pose.dim() == 2 and pose.shape[-1] == 7


def lift(x, y, z, intrinsics):
    """Pixel coords -> homogeneous camera-space points (rend_util.py:87-100)."""
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def get_camera_params(uv: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor):
    """uv (B,P,2), pose (B,4,4) cam-to-world or (B,7), intrinsics (B,4,4) ->
    (ray_dirs (B,P,3), cam_loc (B,3)).  rend_util.py:48-75."""
    if _is_pose7(pose):
        cam_loc = pose[:, 4:]
        pose = pose7_to_matrix(pose)
    else:
        cam_loc = pose[:, :3, 3]
    B, P, _ = uv.shape
    depth = torch.ones((B, P), dtype=uv.dtype, device=uv.device)
    pixel_points_cam = lift(uv[:, :, 0], uv[:, :, 1], depth, intrinsics)  # (B,P,4)
    world_coords = torch.einsum("bij,bpj->bpi", pose, pixel_points_cam)[:, :, :3]
    ray_dirs = world_coords - cam_loc[:, None, :]
    ray_dirs = ray_dirs / torch.linalg.vector_norm(ray_dirs, dim=-1, keepdim=True)
    return ray_dirs, cam_loc


def get_sphere_intersection(cam_loc: torch.Tensor, ray_directions: torch.Tensor,
                            r: float = 1.0):
    """Closed-form ray/sphere(0, r) intersection (rend_util.py:141-162):
    (near/far (B,P,2) clamped >= 0 and zero on a miss, mask_intersect (B,P))."""
    ray_cam_dot = torch.einsum("bpi,bi->bp", ray_directions, cam_loc)
    under_sqrt = ray_cam_dot**2 - ((cam_loc**2).sum(dim=-1)[:, None] - r**2)
    mask_intersect = under_sqrt > 0
    sqrt_val = torch.sqrt(torch.clamp_min(under_sqrt, 0.0))
    si = torch.stack([-ray_cam_dot - sqrt_val, -ray_cam_dot + sqrt_val], dim=-1)
    si = torch.where(mask_intersect[..., None], si, torch.zeros_like(si))
    return torch.clamp_min(si, 0.0), mask_intersect


def get_depth(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Depth of world points (B,P,3) under pose (B,4,4) or (B,7) -> (B,P,1)
    (rend_util.py:164-181)."""
    if _is_pose7(pose):
        pose = pose7_to_matrix(pose)
    points_hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    points_cam = torch.einsum("bij,bpj->bpi", torch.linalg.inv(pose), points_hom)
    return points_cam[:, :, 2:3]


def uv_grid(img_res) -> np.ndarray:
    """Full-image pixel grid, (H*W, 2) float32 with uv[:,0]=x (col), uv[:,1]=y
    (scene_dataset.py:72-74)."""
    H, W = img_res
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([xx, yy], axis=-1).reshape(-1, 2)
