"""The DTU-shaped scan, rendered on the device at set-up.

A frozen copy of the analytic SDFs, the shading, the sphere-tracing renderer
and the camera arc of the port's ``data/dtu_shaped.py`` (which writes the
same scene to PNG files): scan 0 is a tilted torus, two spheres and a rounded
box, smooth-min blended, under a high-frequency procedural texture, seen
from 49 views of 1200x1600 on a DTU-like arc.  Here the views are traced in
batches on the device and kept there as the train step reads them: RGB
uint8 (V, H*W, 3), masks bool (V, H*W), the pixel grid (H*W, 2) and each
view's intrinsics and camera-to-world pose (V, 4, 4).  Nothing is written
to disk.  The scene does not depend on the run's seed."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


_TORUS_R = np.asarray(_rot_x(0.52), dtype=np.float32)
_BOX_R = np.asarray(_rot_y(0.65) @ _rot_x(0.35), dtype=np.float32)
_S1_TORUS_R = np.asarray(_rot_y(1.2) @ _rot_x(1.0), dtype=np.float32)
_S2_BOX_R = np.asarray(_rot_y(0.4), dtype=np.float32)


_CONSTS: Dict = {}


def _t(a, like):
    """A float32 constant on ``like``'s device, copied there once."""
    arr = np.asarray(a, dtype=np.float32)
    key = (arr.tobytes(), arr.shape, str(like.device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(arr, device=like.device)
    return _CONSTS[key]


def _smin(a, b, k=0.06):
    h = torch.clamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b + h * (a - b) - k * h * (1.0 - h)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _rounded_box(b, half, r):
    outer = torch.abs(b) - half
    return (_norm(torch.clamp_min(outer, 0.0))
            + torch.clamp_max(torch.amax(outer, dim=-1), 0.0) - r)


def _scan0_sdf(p):
    q = (p - _t([0.0, 0.05, 0.0], p)) @ _t(_TORUS_R.T, p)
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - 0.30
    d_torus = torch.sqrt(ring**2 + q[..., 1] ** 2) - 0.11
    d_sph_a = _norm(p - _t([0.24, 0.14, -0.06], p)) - 0.17
    b = (p - _t([-0.20, -0.10, 0.06], p)) @ _t(_BOX_R.T, p)
    d_box = _rounded_box(b, _t([0.15, 0.10, 0.12], p), 0.02)
    d_sph_b = _norm(p - _t([0.02, -0.24, -0.16], p)) - 0.13
    d = _smin(d_torus, d_sph_a)
    d = _smin(d, d_box)
    return _smin(d, d_sph_b)


def _scan1_sdf(p):
    a = _t([-0.05, -0.25, 0.0], p)
    ab = _t([0.0, 0.53, 0.0], p)
    t = torch.clamp(((p - a) * ab).sum(dim=-1) / torch.dot(ab, ab), 0.0, 1.0)
    d_cap = _norm(p - a - t[..., None] * ab[None, :]) - 0.12
    q = (p - _t([0.17, 0.0, 0.10], p)) @ _t(_S1_TORUS_R.T, p)
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - 0.27
    d_torus = torch.sqrt(ring**2 + q[..., 1] ** 2) - 0.09
    r = _t([0.20, 0.11, 0.14], p)
    e = (p - _t([0.05, -0.18, -0.18], p)) / r
    d_ell = (_norm(e) - 1.0) * torch.amin(r)
    d_sph = _norm(p - _t([-0.25, 0.10, -0.15], p)) - 0.12
    d = _smin(d_cap, d_torus, k=0.05)
    d = _smin(d, d_ell, k=0.05)
    return _smin(d, d_sph, k=0.05)


def _scan2_sdf(p):
    d_blob = _norm(p - _t([0.0, 0.06, 0.0], p)) - 0.34
    bump = (torch.sin(18.0 * p[..., 0]) * torch.sin(18.0 * p[..., 1])
            * torch.sin(18.0 * p[..., 2]))
    d_blob = d_blob + 0.030 * bump
    b = (p - _t([0.0, -0.33, 0.0], p)) @ _t(_S2_BOX_R.T, p)
    d_slab = _rounded_box(b, _t([0.30, 0.05, 0.30], p), 0.02)
    return _smin(d_blob, d_slab, k=0.07)


SCENE_SDFS = {0: _scan0_sdf, 1: _scan1_sdf, 2: _scan2_sdf}


def scene_color(p, n, view, scene_id=0):
    """Procedural albedo under two lambert lights and a weak specular."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if scene_id == 1:
        f1, f2, f3, fs = 23.0, 19.0, 27.0, 34.0
    elif scene_id == 2:
        f1, f2, f3, fs = 55.0, 49.0, 61.0, 80.0
    else:
        f1, f2, f3, fs = 41.0, 37.0, 45.0, 60.0
    m1 = 0.5 + 0.5 * torch.sin(f1 * x + 3.0 * torch.sin(13.0 * y))
    m2 = 0.5 + 0.5 * torch.sin(f2 * y + 2.0 * torch.sin(17.0 * z) + 1.7)
    m3 = 0.5 + 0.5 * torch.sin(f3 * z + 2.5 * torch.sin(11.0 * x) + 0.6)
    c_a = torch.stack([m1, m2, m3], dim=-1)
    if scene_id == 2:
        c_b = torch.stack([0.2 + 0.7 * m1, 0.9 - 0.6 * m3, 0.3 + 0.6 * m2], dim=-1)
    else:
        c_b = torch.stack([0.9 - 0.6 * m2, 0.2 + 0.7 * m3, 0.3 + 0.6 * m1], dim=-1)
    stripe = (0.5 + 0.5 * torch.sin(fs * (x + y + z)))[..., None]
    albedo = 0.15 + 0.7 * (stripe * c_a + (1 - stripe) * c_b)
    l1 = _t([0.45, 0.75, 0.49], p) / float(np.linalg.norm([0.45, 0.75, 0.49]))
    l2 = _t([-0.6, 0.2, -0.77], p) / float(np.linalg.norm([-0.6, 0.2, -0.77]))
    lam = (0.30 + 0.55 * torch.clamp((n * l1).sum(dim=-1), 0.0, 1.0)
           + 0.25 * torch.clamp((n * l2).sum(dim=-1), 0.0, 1.0))
    h = l1 + view
    h = h / (_norm(h)[..., None] + 1e-9)
    spec = 0.15 * torch.clamp((n * h).sum(dim=-1), 0.0, 1.0) ** 32
    return torch.clamp(albedo * lam[..., None] + spec[..., None], 0.0, 1.0)


def _look_at(cam_pos):
    """World-to-camera rotation, OpenCV convention (z forward, y down)."""
    forward = -cam_pos / np.linalg.norm(cam_pos)
    up_hint = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(forward, up_hint)) > 0.95:
        up_hint = np.array([1.0, 0.0, 0.0])
    right = np.cross(forward, up_hint)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward], axis=0)


def make_cameras(n_views=49, radius=2.2, seed=0):
    """Positions on a DTU-like spherical cap looking at the origin: (pos,
    world-to-camera R) per view."""
    rng = np.random.default_rng(seed)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    cams = []
    for i in range(n_views):
        u = (i + 0.5) / n_views
        elev = np.deg2rad(15.0 + 50.0 * u)
        azim = golden * i + rng.uniform(-0.03, 0.03)
        pos = radius * np.array(
            [np.cos(elev) * np.cos(azim), np.sin(elev), np.cos(elev) * np.sin(azim)])
        cams.append((pos, _look_at(pos)))
    return cams


FAR = 3.5            # a ray past this depth is a miss (the object lies within 0.6)
COMPACT_EVERY = 16


def _trace(cam, dirs, sdf, scene_id, n_iters=192):
    """Rays from ``cam`` (M, 3) along ``dirs`` (M, 3) -> (rgb (M, 3) in [0,
    1], hit (M,)): ``n_iters`` under-relaxed sphere-tracing steps, the hit
    test, normals by autograd and the shading.  Every ``COMPACT_EVERY``
    steps the rays past ``FAR`` leave the loop: each is more than 1.3 from
    the origin, where the SDF only grows, so it stays a miss, as it would
    in the full loop."""
    M = dirs.shape[0]
    t = torch.ones(M, dtype=torch.float32, device=dirs.device)
    live = torch.arange(M, device=dirs.device)
    with torch.no_grad():
        c, d, tl = cam, dirs, t
        for k in range(n_iters):
            if k % COMPACT_EVERY == 0 and k:
                t[live] = tl
                keep = tl <= FAR
                live, c, d, tl = live[keep], c[keep], d[keep], tl[keep]
            tl = tl + 0.9 * sdf(c + tl[:, None] * d)
        t[live] = tl
        p = c + tl[:, None] * d
    with torch.enable_grad():
        p = p.requires_grad_(True)
        dist = sdf(p)
        (n,) = torch.autograd.grad(dist.sum(), p)
    with torch.no_grad():
        dist, p = dist.detach(), p.detach()
        hit_l = (torch.abs(dist) < 1e-3) & (tl < FAR)
        n = n / (_norm(n)[..., None] + 1e-9)
        rgb_l = torch.where(hit_l[:, None], scene_color(p, n, -d, scene_id), 0.0)
        rgb = torch.zeros((M, 3), dtype=torch.float32, device=dirs.device)
        hit = torch.zeros(M, dtype=torch.bool, device=dirs.device)
        rgb[live], hit[live] = rgb_l, hit_l
        return rgb, hit


def build_scene(traffic: Dict, device, views_per_batch: int = 7) -> Dict[str, torch.Tensor]:
    """The scan that ``traffic`` names (``scene_id``, ``n_views``,
    ``img_res``), rendered on ``device``: the tensors the train step
    gathers from, RGB uint8."""
    scene_id = int(traffic.get("scene_id", 0))
    n_views = int(traffic["n_views"])
    H, W = (int(v) for v in traffic["img_res"])
    device = torch.device(device)
    K = np.eye(3, dtype=np.float64)
    K[0, 0] = K[1, 1] = 2200.0 * (W / 1600.0)
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    cams = make_cameras(n_views, seed=scene_id)
    intr = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    intr[:, :3, :3] = K
    pose = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    for i, (pos, R) in enumerate(cams):
        pose[i, :3, :3] = R.T
        pose[i, :3, 3] = pos
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    uv = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    d_cam = torch.stack([(uv[:, 0] - float(K[0, 2])) / float(K[0, 0]),
                         (uv[:, 1] - float(K[1, 2])) / float(K[1, 1]),
                         torch.ones_like(uv[:, 0])], dim=-1)
    rgb = torch.empty((n_views, H * W, 3), dtype=torch.uint8, device=device)
    mask = torch.empty((n_views, H * W), dtype=torch.bool, device=device)
    sdf = SCENE_SDFS[scene_id]
    for v0 in range(0, n_views, views_per_batch):
        v1 = min(v0 + views_per_batch, n_views)
        R_w2c = torch.as_tensor(np.stack([cams[i][1] for i in range(v0, v1)]),
                                dtype=torch.float32, device=device)
        cam = torch.as_tensor(np.stack([cams[i][0] for i in range(v0, v1)]),
                              dtype=torch.float32, device=device)
        dirs = torch.einsum("nj,bjk->bnk", d_cam, R_w2c)
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        origins = cam[:, None, :].expand(dirs.shape).reshape(-1, 3)
        img, hit = _trace(origins, dirs.reshape(-1, 3), sdf, scene_id)
        rgb[v0:v1] = (img * 255.0 + 0.5).to(torch.uint8).view(v1 - v0, H * W, 3)
        mask[v0:v1] = hit.view(v1 - v0, H * W)
    return {"rgb": rgb, "mask": mask, "uv": uv,
            "intrinsics": torch.as_tensor(intr, device=device),
            "pose": torch.as_tensor(pose, device=device)}
