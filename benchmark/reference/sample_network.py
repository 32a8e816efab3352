"""Frozen copy of the port's ``hashmodnffbanks_idr_tpu_torch/models/sample_network.py`` for the
benchmark's plain reference; it imports nothing of the port (changes: none).

Differentiable ray-surface intersection (IDR eq. 3).

Counterpart of ``hashmodnffbanks_idr_tpu/models/sample_network.py``:

    t(theta) = t0 - (sdf(x0; theta) - sdf0) / (grad0 . v)

with ``grad0`` and ``sdf0`` detached.  Masked rays get a denominator of 1 so
no inf/NaN reaches the backward pass through ``where``.  A subnormal
denominator is flushed to 0 first, as XLA flushes subnormals on the CPU and
the TPU: a valid ray whose ``grad0 . v`` is subnormal then gives 0 / 0 as
in the JAX package, not a finite point whose gradient overflows.
"""

from __future__ import annotations

import torch


def sample_network(surface_output, surface_sdf_values, surface_points_grad,
                   surface_dists, surface_cam_loc, surface_ray_dirs, valid_mask=None):
    dot = (surface_points_grad * surface_ray_dirs.detach()).sum(dim=-1, keepdim=True)
    dot = torch.where(torch.abs(dot) < torch.finfo(dot.dtype).tiny, torch.zeros_like(dot), dot)
    ones = torch.ones_like(dot)
    if valid_mask is not None:
        dot = torch.where(valid_mask[:, None], dot, ones)
    else:
        dot = torch.where(torch.abs(dot) < 1e-12, ones, dot)
    dists_theta = surface_dists - (surface_output - surface_sdf_values) / dot
    return surface_cam_loc + dists_theta * surface_ray_dirs
