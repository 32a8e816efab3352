"""In-memory synthetic scenes + conf builders (chip_smoke.py / tests).

A copy of ``hashmodnffbanks_idr_tpu/testing.py``; ``scene_to_device``,
``NGP_PRESETS`` and ``ngp_conf`` are new.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .config.hocon import Config, parse


def synthetic_scene(n_views: int = 3, img_res=(32, 32), seed: int = 0) -> Dict[str, np.ndarray]:
    """Device-array dict shaped like SceneDataset.device_arrays(), without disk.

    Cameras on a radius-2 sphere looking at the origin; random images/masks.
    """
    from .geometry.cameras import uv_grid

    rng = np.random.default_rng(seed)
    H, W = img_res
    HW = H * W
    focal = 1.2 * max(H, W)

    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal
    K[0, 2] = W / 2.0
    K[1, 2] = H / 2.0

    poses = []
    for i in range(n_views):
        phi = 2 * np.pi * i / n_views
        pos = 2.0 * np.array([np.cos(phi), 0.3, np.sin(phi)])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.stack([right, down, fwd], axis=1)  # cam-to-world cols
        pose[:3, 3] = pos
        poses.append(pose)

    return {
        "rgb": rng.integers(0, 255, (n_views, HW, 3), dtype=np.uint8),
        "mask": rng.random((n_views, HW)) > 0.5,
        "uv": uv_grid(img_res),
        "intrinsics": np.tile(K[None], (n_views, 1, 1)),
        "pose": np.stack(poses),
    }


def scene_to_device(scene: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The scene arrays as tensors on ``device`` (None -> the CUDA card)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v, device=device) for k, v in scene.items()}


def flagship_conf(num_pixels: int = 2048, small: bool = False,
                  embed_type: str = "StyleModNFFB",
                  viewdirs_embed_type: str = "StyleModNFFB") -> Config:
    """The StyleModNFFB DTU config (the benchmark workload); `small=True`
    shrinks the MLPs / tracer for CPU-sized smoke runs."""
    dims = "[ 64, 64, 64, 64, 64, 64 ]" if small else "[ 512, 512, 512, 512, 512, 512, 512, 512 ]"
    rdims = "[ 64, 64 ]" if small else "[ 512, 512, 512, 512]"
    fvs = 32 if small else 256
    n_steps = 32 if small else 100
    st_iters = 5 if small else 10
    return parse(f"""
train{{
    expname = bench
    learning_rate = 1.0e-4
    num_pixels = {num_pixels}
    plot_freq = 100
    alpha_milestones = [250,500,750,1000,1250]
    alpha_factor = 2
    sched_milestones = [1000,1500]
    sched_factor = 0.5
}}
plot{{
    plot_nimgs = 1
    max_depth = 3.0
    resolution = 100
}}
loss{{
    eikonal_weight = 0.1
    mask_weight = 200.0
    alpha = 50.0
}}
dataset{{
    data_dir = DTU
    img_res = [1200, 1600]
    scan_id = 65
}}
model{{
    feature_vector_size = {fvs}
    implicit_network {{
        d_in = 3
        d_out = 1
        dims = {dims}
        geometric_init = True
        bias = 0.6
        skip_in = [4]
        weight_norm = True
        multires = 6
    }}
    rendering_network {{
        mode = idr
        d_in = 9
        d_out = 3
        viewdirs_embed_type = {viewdirs_embed_type}
        dims = {rdims}
        weight_norm = True
        multires_view = 4
    }}
    ray_tracer {{
        object_bounding_sphere = 1.0
        sdf_threshold = 5.0e-5
        line_search_step = 0.5
        line_step_iters = 3
        sphere_tracing_iters = {st_iters}
        n_steps = {n_steps}
        n_secant_steps = 8
    }}
    embedding_network {{
        embed_type = {embed_type}
        log2_max_hash_size = 5
        max_points_per_entry = 2
        base_resolution = 16
        desired_resolution = 512
        bound = 0.45
    }}
}}
""")


# The JAX package's bench.py ngp presets (bench.py:126-150): the instant-ngp
# grid (HashGridTcnn, 6 levels x 2 features) at log2_max_hash_size 15 and 19
# with their level-pruned tracer guidance (prune_levels_march,
# prune_levels_coarse, prune_secant_iters).  With 6 levels, 16 and 6 prune no
# level and leave floor-corner guidance only; 'ngp_log2_15_k3' keeps the 3
# coarsest levels, so the pruned encode and its level-mean fill run.
NGP_PRESETS = {
    "ngp_log2_15": (15, (16, 16, 4)),
    "ngp_log2_19": (19, (6, 6, 4)),
    "ngp_log2_15_k3": (15, (3, 3, 4)),
}


def ngp_conf(preset: str = "ngp_log2_15", num_pixels: int = 2048) -> Config:
    """``flagship_conf(embed_type='HashGridTcnn')`` with one of
    ``NGP_PRESETS``' table size and prune settings, as bench.py builds them."""
    log2, (march, coarse, secant) = NGP_PRESETS[preset]
    conf = flagship_conf(num_pixels=num_pixels, embed_type="HashGridTcnn")
    conf.put("model.embedding_network.log2_max_hash_size", log2)
    conf.put("model.ray_tracer.prune_levels_march", march)
    conf.put("model.ray_tracer.prune_levels_coarse", coarse)
    conf.put("model.ray_tracer.prune_secant_iters", secant)
    return conf
