"""Synthetic dummy scene generator — the smoke fixture (a copy of
``hashmodnffbanks_idr_tpu/data/dummy.py`` that writes through ``image_io``).

Equivalent in role to the reference's data/generate_dummy_data.py (which
renders a colored cube with pyrender); here the cube is ray-traced directly in
NumPy (no renderer dependency): N views of a lambert-shaded colored cube with
exact cameras written in the repo's npz convention (DATA_CONVENTION.md —
``world_mat_i`` = 4x4 [K[R|t]; 0 0 0 1], ``scale_mat_i`` = normalization; the
scene is built inside the unit sphere so scale_mat = I).

Also writes ``cameras_linear_init.npz`` with rotation/translation noise for
the trainable-camera path.
"""

from __future__ import annotations

import os

import numpy as np

from .image_io import write_png

FACE_COLORS = np.array(
    [
        [0.90, 0.25, 0.20],  # +x
        [0.20, 0.75, 0.30],  # -x
        [0.20, 0.35, 0.90],  # +y
        [0.95, 0.85, 0.25],  # -y
        [0.85, 0.30, 0.85],  # +z
        [0.25, 0.85, 0.85],  # -z
    ]
)


def _look_at(cam_pos: np.ndarray) -> np.ndarray:
    """World-to-camera rotation, OpenCV convention (z forward, y down)."""
    forward = -cam_pos / np.linalg.norm(cam_pos)  # toward origin
    up_hint = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(forward, up_hint)) > 0.95:
        up_hint = np.array([1.0, 0.0, 0.0])
    right = np.cross(forward, up_hint)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward], axis=0)


def _render_cube(cam_pos, R_w2c, K, image_size, half=0.35, light_dir=(0.3, -0.5, 0.8)):
    """Ray-trace an axis-aligned cube of half-size `half` at the origin."""
    S = image_size
    ys, xs = np.mgrid[0:S, 0:S].astype(np.float64)
    d_cam = np.stack(
        [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)], axis=-1
    )
    d_world = d_cam @ R_w2c  # == R^T d
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)

    o = cam_pos[None, None, :]
    inv = 1.0 / np.where(np.abs(d_world) < 1e-12, 1e-12, d_world)
    t0 = (-half - o) * inv
    t1 = (half - o) * inv
    tmin_ax = np.minimum(t0, t1)
    tmax_ax = np.maximum(t0, t1)
    tmin = tmin_ax.max(axis=-1)
    tmax = tmax_ax.min(axis=-1)
    hit = (tmin < tmax) & (tmax > 0)

    entry_axis = np.argmax(tmin_ax, axis=-1)
    hit_pts = o + tmin[..., None] * d_world
    sign_pos = np.take_along_axis(d_world, entry_axis[..., None], axis=-1)[..., 0] < 0
    face = entry_axis * 2 + (~sign_pos).astype(int)  # (+axis -> even, -axis -> odd)

    normal = np.zeros_like(hit_pts)
    np.put_along_axis(normal, entry_axis[..., None],
                      np.where(sign_pos, 1.0, -1.0)[..., None], axis=-1)
    ld = np.asarray(light_dir, dtype=np.float64)
    ld /= np.linalg.norm(ld)
    lambert = np.clip(np.einsum("hwc,c->hw", normal, ld), 0.0, 1.0) * 0.6 + 0.4

    img = np.ones((S, S, 3))
    colors = FACE_COLORS[np.clip(face, 0, 5)]
    img = np.where(hit[..., None], colors * lambert[..., None], img)
    return (img * 255).astype(np.uint8), hit


def generate_dummy_scene(out_dir: str, n_views: int = 10, image_size: int = 64,
                         focal: float = 70.0, radius: float = 2.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)

    K = np.eye(3)
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = K[1, 2] = image_size / 2.0

    cameras = {}
    cameras_noisy = {}
    for i in range(n_views):
        # spread view points over the sphere, jittered
        phi = 2 * np.pi * (i / n_views) + rng.uniform(-0.1, 0.1)
        costh = rng.uniform(-0.5, 0.7)
        theta = np.arccos(costh)
        pos = radius * np.array(
            [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)]
        )
        R = _look_at(pos)
        t = -R @ pos
        img, mask = _render_cube(pos, R, K, image_size)

        wm = np.eye(4)
        wm[:3, :3] = K @ R
        wm[:3, 3] = K @ t
        cameras[f"world_mat_{i}"] = wm
        cameras[f"scale_mat_{i}"] = np.eye(4)

        # noisy init: small rotation + translation perturbation
        ang = rng.normal(scale=0.03, size=3)
        Rx = _rotvec_to_mat(ang)
        Rn = Rx @ R
        tn = t + rng.normal(scale=0.02, size=3)
        wmn = np.eye(4)
        wmn[:3, :3] = K @ Rn
        wmn[:3, 3] = K @ tn
        cameras_noisy[f"world_mat_{i}"] = wmn
        cameras_noisy[f"scale_mat_{i}"] = np.eye(4)

        write_png(os.path.join(out_dir, "image", f"{i:03d}.png"), img)
        write_png(os.path.join(out_dir, "mask", f"{i:03d}.png"),
                   (mask * 255).astype(np.uint8))

    np.savez(os.path.join(out_dir, "cameras.npz"), **cameras)
    np.savez(os.path.join(out_dir, "cameras_linear_init.npz"), **cameras_noisy)
    return out_dir


def _rotvec_to_mat(v: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)
