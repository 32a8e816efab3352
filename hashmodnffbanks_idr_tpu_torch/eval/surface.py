"""Surface (mesh) extraction from the trained SDF.

Counterpart of ``hashmodnffbanks_idr_tpu/eval/surface.py`` (utils/plots.py:
110-224 of the reference): evaluate the SDF on a grid in fixed-size chunks
on the device, run marching tetrahedra, keep the largest component,
optionally do the reference's two-pass PCA-aligned refinement, and export
PLY.  ``sdf_fn`` is a torch callable, (N, 3) float32 -> (N,); the grid is
built in numpy exactly as the JAX package builds it, goes to the device
once, and the values come back once per grid.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.mesh_extract import largest_component, marching_tetrahedra
from ..utils.ply import write_ply


def make_chunked_sdf(sdf_fn: Callable[[torch.Tensor], torch.Tensor], chunk: int = 262144,
                     device=None) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap a torch sdf into a host function: numpy points (N, 3) go to
    ``device`` (None -> the CUDA card) as float32, are evaluated in chunks
    of ``chunk`` under ``torch.no_grad()``, and come back as one float32
    array read back once."""
    device = resolve_device(device)

    @torch.no_grad()
    def eval_points(pts: np.ndarray) -> np.ndarray:
        if len(pts) == 0:
            return np.empty(0, dtype=np.float32)
        x = torch.as_tensor(np.asarray(pts, dtype=np.float32), device=device)
        outs = [sdf_fn(x[s:s + chunk]) for s in range(0, len(x), chunk)]
        return torch.cat(outs).float().cpu().numpy()

    return eval_points


def grid_points(resolution: int, bounds: np.ndarray) -> Tuple[np.ndarray, tuple]:
    """bounds: (2, 3) [min, max] -> points (res^3, 3) + axes."""
    axes = [np.linspace(bounds[0, d], bounds[1, d], resolution) for d in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return g.reshape(-1, 3), tuple(axes)


def get_surface_mesh(
    sdf_fn: Callable,
    resolution: int = 100,
    bounds: Optional[np.ndarray] = None,
    level: float = 0.0,
    chunk: int = 262144,
    keep_largest: bool = False,
    device=None,
):
    """Single-pass extraction (utils/plots.py:110-144 role)."""
    if bounds is None:
        bounds = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])
    eval_pts = make_chunked_sdf(sdf_fn, chunk, device)
    pts, axes = grid_points(resolution, bounds)
    vals = eval_pts(pts).reshape(resolution, resolution, resolution)
    verts, faces = marching_tetrahedra(vals, level=level)
    if len(verts) == 0:
        return verts, faces
    # grid coords -> world
    scale = (bounds[1] - bounds[0]) / (resolution - 1)
    verts = verts * scale[None, :] + bounds[0][None, :]
    if keep_largest:
        verts, faces = largest_component(verts, faces)
    return verts, faces


def get_surface_high_res_mesh(
    sdf_fn: Callable,
    resolution: int = 400,
    chunk: int = 262144,
    device=None,
):
    """Two-pass refinement (utils/plots.py:146-224): coarse 100^3 pass ->
    largest component -> PCA-aligned bounding box -> fine pass on the aligned
    grid -> mesh back in world coordinates."""
    v_low, f_low = get_surface_mesh(sdf_fn, resolution=100, keep_largest=True, chunk=chunk,
                                    device=device)
    if len(v_low) == 0:
        return v_low, f_low

    # PCA alignment of the coarse component (plots.py:167-186)
    mean = v_low.mean(axis=0)
    centered = v_low - mean
    cov = centered.T @ centered / len(v_low)
    eigval, eigvec = np.linalg.eigh(cov)
    # principal frame: columns of eigvec; align grid to it
    rot = eigvec  # world <- aligned: x_world = rot @ x_aligned + mean
    aligned = centered @ rot
    lo = aligned.min(axis=0) - 0.1
    hi = aligned.max(axis=0) + 0.1

    axes = [np.linspace(lo[d], hi[d], resolution) for d in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    world = g @ rot.T + mean

    eval_pts = make_chunked_sdf(sdf_fn, chunk, device)
    vals = eval_pts(world).reshape(resolution, resolution, resolution)
    verts, faces = marching_tetrahedra(vals, level=0.0)
    if len(verts) == 0:
        return verts, faces
    scale = (hi - lo) / (resolution - 1)
    verts = verts * scale[None, :] + lo[None, :]
    verts = verts @ rot.T + mean
    verts, faces = largest_component(verts, faces)
    return verts, faces


def export_surface(path: str, sdf_fn, resolution=100, transform=None, **kw):
    verts, faces = get_surface_mesh(sdf_fn, resolution=resolution, **kw)
    if transform is not None and len(verts):
        verts = verts @ transform[:3, :3].T + transform[:3, 3]
    write_ply(path, verts, faces)
    return verts, faces
