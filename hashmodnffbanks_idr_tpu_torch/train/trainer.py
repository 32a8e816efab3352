"""The training step: pixel gather -> render -> IDR loss -> clipped Adam.

Counterpart of ``hashmodnffbanks_idr_tpu/train/trainer.py:build_train_step``
for fixed cameras.  The gradient is clipped to a global norm of 1.0 exactly
as ``optax.clip_by_global_norm`` does (idr_train.py:306), then a
``torch.optim.Adam`` step is taken (its update is algebraically optax's).

Still to port: ``IDRTrainRunner``, the ``exp_runner`` CLI, checkpoints, the
LR/alpha schedules, ``SceneDataset`` and SparseAdam for trainable cameras.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..data.scene_dataset import rgb_to_pm1
from ..models.loss import IDRLossConfig, idr_loss
from ..models.renderer import IDRNetwork

MAX_GRAD_NORM = 1.0  # idr_train.py:306


def make_optimizer(model: IDRNetwork, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``max_norm / ||g||`` when ``||g|| >= max_norm``,
    as ``optax.clip_by_global_norm`` does (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def loss_fn(model: IDRNetwork, loss_cfg: IDRLossConfig, scene: Dict[str, torch.Tensor],
            img_idx: torch.Tensor, pixel_idx: torch.Tensor,
            generator: Optional[torch.Generator], alpha: float,
            draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Gather the step's pixels from the device-resident scene, render them
    and return the loss terms (JAX :94-126)."""
    B = img_idx.shape[0]
    uv = scene["uv"][pixel_idx][None].expand(B, -1, -1)             # (B, P, 2)
    mask = scene["mask"][img_idx][:, pixel_idx]                     # (B, P)
    rgb_gt = rgb_to_pm1(scene["rgb"][img_idx][:, pixel_idx])        # (B, P, 3)
    inputs = {
        "uv": uv,
        "intrinsics": scene["intrinsics"][img_idx],
        "pose": scene["pose"][img_idx],
        "object_mask": mask,
    }
    outputs = model(inputs, generator=generator, training=True, draws=draws)
    return idr_loss(loss_cfg, outputs, rgb_gt, alpha)


def build_train_step(model: IDRNetwork, loss_cfg: IDRLossConfig,
                     optimizer: torch.optim.Optimizer) -> Callable:
    """One train step over ``model``'s parameters, updated in place:
    ``step(scene, img_idx, pixel_idx, generator, alpha, draws=None)`` returns
    the detached loss terms (no host synchronisation)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(scene, img_idx, pixel_idx, generator, alpha, draws=None):
        optimizer.zero_grad(set_to_none=True)
        losses = loss_fn(model, loss_cfg, scene, img_idx, pixel_idx, generator, alpha,
                         draws=draws)
        losses["loss"].backward()
        clip_by_global_norm(params, MAX_GRAD_NORM)
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return step
