"""What the reference's frozen copies need besides themselves: a dotted-path
accessor over the configuration's dict (the part of the port's
``config/hocon.py:Config`` that the model reads), the camera rays and the
bounding-sphere intersection (``geometry/cameras.py``, fixed cameras only),
and the tracer's loop as a plain host loop (the eager form of the port's
``utils/graphs.py:while_loop``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch


class Config:
    """Dotted-path lookups over a nested dict."""

    def __init__(self, data: Dict[str, Any]):
        self._data = data

    @property
    def data(self) -> Dict[str, Any]:
        return self._data

    def _lookup(self, path: str, default=...):
        node: Any = self._data
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                if default is ...:
                    raise KeyError(path)
                return default
            node = node[part]
        return node

    def get(self, path: str, default=None):
        return self._lookup(path, default)

    def get_int(self, path: str, default=...) -> int:
        return int(self._lookup(path, default))

    def get_float(self, path: str, default=...) -> float:
        return float(self._lookup(path, default))

    def get_config(self, path: str, default=...) -> "Config":
        v = self._lookup(path, default)
        if v is None or v is default and not isinstance(v, dict):
            return v
        if not isinstance(v, dict):
            raise TypeError(f"{path} is not a config block")
        return Config(v)


def while_loop(cond: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
               body: Callable[[Dict[str, torch.Tensor], Optional[int]], None],
               state: Dict[str, torch.Tensor], max_iters: int,
               counter: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Run ``body(state, i)`` while ``i < max_iters`` and ``cond(state)``;
    the counter, a 0-d int64 tensor, is ``state[counter]`` when named."""
    if max_iters <= 0:
        return state
    i_dev = torch.zeros((), dtype=torch.int64, device=next(iter(state.values())).device)
    if counter:
        state[counter] = i_dev
    i = 0
    while i < max_iters and bool(cond(state)):
        body(state, i)
        i_dev.add_(1)
        i += 1
    return state


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
    """uv (B,P,2), pose (B,4,4) cam-to-world, intrinsics (B,4,4) ->
    (ray_dirs (B,P,3), cam_loc (B,3)).  rend_util.py:48-75."""
    cam_loc = pose[:, :3, 3]
    B, P, _ = uv.shape
    depth = torch.ones((B, P), dtype=uv.dtype, device=uv.device)
    pixel_points_cam = lift(uv[:, :, 0], uv[:, :, 1], depth, intrinsics)
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
