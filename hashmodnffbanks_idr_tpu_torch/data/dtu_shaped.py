"""DTU-shaped synthetic quality benchmark scene.

Counterpart of ``hashmodnffbanks_idr_tpu/data/dtu_shaped.py`` in torch.  It
renders a scene with a DTU scan's shape — by default 49 views at 1200x1600
with masks and unit-sphere-normalized cameras in the repo's npz convention
(DATA_CONVENTION.md, mirroring the reference's
code/datasets/scene_dataset.py:8-160 contract) — from a *known analytic
SDF*, which yields both ground-truth images (for PSNR/SSIM/LPIPS) and a
ground-truth mesh (for the Chamfer harness, eval/dtu_chamfer.py).

Scene 0: a tilted torus, two spheres and a rotated rounded box, polynomial
smooth-min blended, shaded with a high-frequency procedural 3D texture.
Scenes 1 and 2 vary the geometry and the texture frequencies.

The analytic SDF is sphere-traced on the device (the CUDA card unless
``--platform cpu``): 192 under-relaxed steps, the hit test, normals by
``torch.autograd.grad`` of the SDF, and the shading.  Images go through
``image_io.write_png``; the GT mesh through the copied marching tetrahedra.

CLI:  python -m hashmodnffbanks_idr_tpu_torch.data.dtu_shaped --out data
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from .dummy import _look_at, _rotvec_to_mat
from .image_io import write_png


# ---------------------------------------------------------------------------
# analytic SDF (unit-sphere scene, object radius ~0.5)
# ---------------------------------------------------------------------------

def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


_TORUS_R = np.asarray(_rot_x(0.52), dtype=np.float32)       # ~30 deg tilt
_BOX_R = np.asarray(_rot_y(0.65) @ _rot_x(0.35), dtype=np.float32)
_S1_TORUS_R = np.asarray(_rot_y(1.2) @ _rot_x(1.0), dtype=np.float32)
_S2_BOX_R = np.asarray(_rot_y(0.4), dtype=np.float32)


def _t(a, like):
    """A float32 constant on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=like.device)


def _smin(a, b, k=0.06):
    """Polynomial smooth min (quadratic)."""
    h = torch.clamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b + h * (a - b) - k * h * (1.0 - h)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _rounded_box(b, half, r):
    outer = torch.abs(b) - half
    return (_norm(torch.clamp_min(outer, 0.0))
            + torch.clamp_max(torch.amax(outer, dim=-1), 0.0) - r)


def _scan0_sdf(p: torch.Tensor) -> torch.Tensor:
    # tilted torus, major 0.30 / minor 0.11, centered slightly above origin
    q = (p - _t([0.0, 0.05, 0.0], p)) @ _t(_TORUS_R.T, p)
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - 0.30
    d_torus = torch.sqrt(ring**2 + q[..., 1] ** 2) - 0.11

    # sphere A
    d_sph_a = _norm(p - _t([0.24, 0.14, -0.06], p)) - 0.17

    # rotated rounded box
    b = (p - _t([-0.20, -0.10, 0.06], p)) @ _t(_BOX_R.T, p)
    d_box = _rounded_box(b, _t([0.15, 0.10, 0.12], p), 0.02)

    # sphere B (bottom)
    d_sph_b = _norm(p - _t([0.02, -0.24, -0.16], p)) - 0.13

    d = _smin(d_torus, d_sph_a)
    d = _smin(d, d_box)
    d = _smin(d, d_sph_b)
    return d


def _scan1_sdf(p: torch.Tensor) -> torch.Tensor:
    """Scan 1: vertical capsule + near-vertical torus + ellipsoid + sphere —
    elongated shapes and a thin handle."""
    # vertical capsule
    a = _t([-0.05, -0.25, 0.0], p)
    ab = _t([0.0, 0.53, 0.0], p)          # to (-0.05, 0.28, 0)
    t = torch.clamp(((p - a) * ab).sum(dim=-1) / torch.dot(ab, ab), 0.0, 1.0)
    d_cap = _norm(p - a - t[..., None] * ab[None, :]) - 0.12

    # near-vertical thin torus (the handle)
    q = (p - _t([0.17, 0.0, 0.10], p)) @ _t(_S1_TORUS_R.T, p)
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - 0.27
    d_torus = torch.sqrt(ring**2 + q[..., 1] ** 2) - 0.09

    # ellipsoid (bound-accurate approximation)
    r = _t([0.20, 0.11, 0.14], p)
    e = (p - _t([0.05, -0.18, -0.18], p)) / r
    d_ell = (_norm(e) - 1.0) * torch.amin(r)

    d_sph = _norm(p - _t([-0.25, 0.10, -0.15], p)) - 0.12

    d = _smin(d_cap, d_torus, k=0.05)
    d = _smin(d, d_ell, k=0.05)
    d = _smin(d, d_sph, k=0.05)
    return d


def _scan2_sdf(p: torch.Tensor) -> torch.Tensor:
    """Scan 2: displacement-bumped blob on a flat slab — high-frequency
    geometry, not just texture."""
    d_blob = _norm(p - _t([0.0, 0.06, 0.0], p)) - 0.34
    bump = (torch.sin(18.0 * p[..., 0]) * torch.sin(18.0 * p[..., 1])
            * torch.sin(18.0 * p[..., 2]))
    d_blob = d_blob + 0.030 * bump

    b = (p - _t([0.0, -0.33, 0.0], p)) @ _t(_S2_BOX_R.T, p)
    d_slab = _rounded_box(b, _t([0.30, 0.05, 0.30], p), 0.02)
    return _smin(d_blob, d_slab, k=0.07)


_SCENE_SDFS = {0: _scan0_sdf, 1: _scan1_sdf, 2: _scan2_sdf}


def scene_sdf(p: torch.Tensor, scene_id: int = 0) -> torch.Tensor:
    """p: (..., 3) -> (...,) signed distance of benchmark scene ``scene_id``."""
    return _SCENE_SDFS[int(scene_id)](p.to(torch.float32))


def scene_color(p: torch.Tensor, n: torch.Tensor, view: torch.Tensor,
                scene_id: int = 0) -> torch.Tensor:
    """High-frequency procedural albedo + two-light lambert + weak specular.

    p: (..., 3) surface points, n: (..., 3) unit normals, view: (..., 3) unit
    directions surface->camera.  Returns (..., 3) in [0, 1]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if scene_id == 1:
        f1, f2, f3, fs = 23.0, 19.0, 27.0, 34.0
    elif scene_id == 2:
        f1, f2, f3, fs = 55.0, 49.0, 61.0, 80.0
    else:
        f1, f2, f3, fs = 41.0, 37.0, 45.0, 60.0
    # three mixing fields at different (high) frequencies
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
    lam = (
        0.30
        + 0.55 * torch.clamp((n * l1).sum(dim=-1), 0.0, 1.0)
        + 0.25 * torch.clamp((n * l2).sum(dim=-1), 0.0, 1.0)
    )
    h = l1 + view
    h = h / (_norm(h)[..., None] + 1e-9)
    spec = 0.15 * torch.clamp((n * h).sum(dim=-1), 0.0, 1.0) ** 32
    return torch.clamp(albedo * lam[..., None] + spec[..., None], 0.0, 1.0)


# ---------------------------------------------------------------------------
# renderer: sphere tracing the analytic SDF
# ---------------------------------------------------------------------------

def trace_chunk(cam_pos: torch.Tensor, dirs: torch.Tensor, n_iters: int = 192,
                scene_id: int = 0):
    """cam_pos (3,), dirs (N, 3) -> (rgb (N, 3), hit (N,))."""
    with torch.no_grad():
        t = torch.full(dirs.shape[:1], 1.0, dtype=torch.float32, device=dirs.device)
        for _ in range(n_iters):
            t = t + 0.9 * scene_sdf(cam_pos[None, :] + t[:, None] * dirs, scene_id)
        p = cam_pos[None, :] + t[:, None] * dirs
    with torch.enable_grad():
        p = p.requires_grad_(True)
        d = scene_sdf(p, scene_id)
        (n,) = torch.autograd.grad(d.sum(), p)
    with torch.no_grad():
        d, p = d.detach(), p.detach()
        hit = (torch.abs(d) < 1e-3) & (t < 3.5)
        n = n / (_norm(n)[..., None] + 1e-9)
        rgb = scene_color(p, n, -dirs, scene_id)
        rgb = torch.where(hit[:, None], rgb, 0.0)
    return rgb, hit


def render_view(cam_pos: np.ndarray, R_w2c: np.ndarray, K: np.ndarray,
                img_res, chunk: int = 1 << 19, scene_id: int = 0, device=None):
    """Render one (H, W) view on ``device`` (None -> the CUDA card); returns
    (rgb uint8 (H, W, 3), mask bool (H, W)), read back once."""
    device = resolve_device(device)
    H, W = img_res
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    d_cam = np.stack(
        [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)],
        axis=-1,
    ).reshape(-1, 3)
    d_world = d_cam @ R_w2c  # R^T d
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)

    dirs = torch.as_tensor(d_world.astype(np.float32), device=device)
    cam = torch.as_tensor(np.asarray(cam_pos, dtype=np.float32), device=device)
    outs = [trace_chunk(cam, dirs[i:i + chunk], 192, scene_id)
            for i in range(0, dirs.shape[0], chunk)]
    rgb = torch.cat([o[0] for o in outs]).cpu().numpy().reshape(H, W, 3)
    hit = torch.cat([o[1] for o in outs]).cpu().numpy().reshape(H, W)
    return (rgb * 255.0 + 0.5).astype(np.uint8), hit


# ---------------------------------------------------------------------------
# cameras: DTU-like upper-hemisphere arc of 49 views
# ---------------------------------------------------------------------------

def make_cameras(n_views: int = 49, radius: float = 2.2, seed: int = 0):
    """Positions on a DTU-like partial spherical cap looking at the origin."""
    rng = np.random.default_rng(seed)
    cams = []
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_views):
        # spiral over elevation band [15deg, 65deg] like a DTU robot arm path
        u = (i + 0.5) / n_views
        elev = np.deg2rad(15.0 + 50.0 * u)
        azim = golden * i + rng.uniform(-0.03, 0.03)
        pos = radius * np.array(
            [np.cos(elev) * np.cos(azim), np.sin(elev), np.cos(elev) * np.sin(azim)]
        )
        R = _look_at(pos)
        t = -R @ pos
        cams.append((pos, R, t))
    return cams


# ---------------------------------------------------------------------------
# generator entry
# ---------------------------------------------------------------------------

def generate_dtu_shaped_scene(
    out_dir: str,
    n_views: int = 49,
    img_res=(1200, 1600),
    mesh_resolution: int = 320,
    seed: int = 0,
    noise_rot: float = 0.015,
    noise_trans: float = 0.012,
    scene_id: int = 0,
    device=None,
):
    """Write image/ mask/ cameras.npz cameras_linear_init.npz gt_mesh.ply."""
    rng = np.random.default_rng(seed + 1)
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)

    H, W = img_res
    K = np.eye(3, dtype=np.float64)
    K[0, 0] = K[1, 1] = 2200.0 * (W / 1600.0)
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0

    cameras, cameras_noisy = {}, {}
    for i, (pos, R, t) in enumerate(make_cameras(n_views, seed=seed + scene_id)):
        img, mask = render_view(pos, R, K, img_res, scene_id=scene_id, device=device)
        write_png(os.path.join(out_dir, "image", f"{i:03d}.png"), img)
        write_png(os.path.join(out_dir, "mask", f"{i:03d}.png"),
                  (mask * 255).astype(np.uint8))

        wm = np.eye(4)
        wm[:3, :3] = K @ R
        wm[:3, 3] = K @ t
        cameras[f"world_mat_{i}"] = wm
        cameras[f"scale_mat_{i}"] = np.eye(4)  # scene is unit-sphere native

        ang = rng.normal(scale=noise_rot, size=3)
        Rn = _rotvec_to_mat(ang) @ R
        tn = t + rng.normal(scale=noise_trans, size=3)
        wmn = np.eye(4)
        wmn[:3, :3] = K @ Rn
        wmn[:3, 3] = K @ tn
        cameras_noisy[f"world_mat_{i}"] = wmn
        cameras_noisy[f"scale_mat_{i}"] = np.eye(4)
        print(f"view {i + 1}/{n_views} rendered (mask px: {int(mask.sum())})",
              flush=True)

    np.savez(os.path.join(out_dir, "cameras.npz"), **cameras)
    np.savez(os.path.join(out_dir, "cameras_linear_init.npz"), **cameras_noisy)

    write_gt_mesh(os.path.join(out_dir, "gt_mesh.ply"), mesh_resolution,
                  scene_id=scene_id, device=device)
    return out_dir


def write_gt_mesh(path: str, resolution: int = 320, bound: float = 0.62,
                  scene_id: int = 0, device=None):
    """Marching-tets mesh of the analytic SDF (Chamfer ground truth): the
    grid is evaluated plane by plane on ``device`` and read back once."""
    from ..ops.mesh_extract import largest_component, marching_tetrahedra
    from ..utils.ply import write_ply

    device = resolve_device(device)
    axis_np = np.linspace(-bound, bound, resolution, dtype=np.float32)
    axis = torch.as_tensor(axis_np, device=device)
    gy, gz = torch.meshgrid(axis, axis, indexing="ij")
    vals = torch.empty((resolution,) * 3, dtype=torch.float32, device=device)
    with torch.no_grad():
        for ix in range(resolution):
            plane = torch.stack([torch.full_like(gy, axis_np[ix]), gy, gz], dim=-1)
            vals[ix] = scene_sdf(plane, scene_id)
    verts, faces = marching_tetrahedra(vals.cpu().numpy())
    # grid coords -> world coords
    step = (2 * bound) / (resolution - 1)
    verts = verts * step - bound
    verts, faces = largest_component(verts, faces)
    write_ply(path, verts, faces)
    print(f"gt mesh: {len(verts)} verts / {len(faces)} faces -> {path}", flush=True)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="data", help="data root (scene goes to <out>/dtu_shaped/scan0)")
    p.add_argument("--n_views", type=int, default=49)
    p.add_argument("--img_res", type=int, nargs=2, default=[1200, 1600])
    p.add_argument("--mesh_resolution", type=int, default=320)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan_id", type=int, default=0,
                   help="scene variant (0: torus+box blob, 1: capsule+handle, "
                        "2: bumpy blob on slab); writes <out>/dtu_shaped/scan<N>")
    p.add_argument("--platform", default=None,
                   help="torch device to render on (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    out_dir = os.path.join(args.out, "dtu_shaped", f"scan{args.scan_id}")
    generate_dtu_shaped_scene(
        out_dir, n_views=args.n_views, img_res=tuple(args.img_res),
        mesh_resolution=args.mesh_resolution, seed=args.seed,
        scene_id=args.scan_id, device=args.platform,
    )
    print(f"dtu_shaped scene written to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
