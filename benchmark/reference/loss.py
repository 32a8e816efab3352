"""Frozen copy of the port's ``hashmodnffbanks_idr_tpu_torch/models/loss.py`` for the
benchmark's plain reference; it imports nothing of the port (changes: none).

IDR loss: masked L1 RGB + eikonal + mask BCE (code/model/loss.py:5-71).

Counterpart of ``hashmodnffbanks_idr_tpu/models/loss.py``: the reference's
boolean-gather reductions are masked sums over all rays divided by the same
denominator, the ray count.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class IDRLossConfig(NamedTuple):
    eikonal_weight: float = 0.1
    mask_weight: float = 100.0
    alpha: float = 50.0   # initial value; the annealed copy is passed per call
    # grid total-variation weight (torch-ngp grad_total_variation slot,
    # gridencoder_torchngp/grid.py:173-196); 0 disables.  The train step adds
    # it at the traced points (train/trainer.py:loss_fn).
    tv_weight: float = 0.0


def rgb_loss(rgb_values, rgb_gt, mask, n_pixels):
    """L1 over (network_object_mask & object_mask) / ray count (loss.py:13-21)."""
    per_ray = torch.abs(rgb_values - rgb_gt).sum(dim=-1)
    return torch.where(mask, per_ray, torch.zeros_like(per_ray)).sum() / n_pixels


def eikonal_loss(grad_theta, n_rows=None):
    """mean((||grad|| - 1)^2) over all eikonal samples (loss.py:35-40); with
    ``n_rows``, the sum over these rows divided by it (a rank's share of a
    mean over ``n_rows`` global rows)."""
    norms = torch.linalg.vector_norm(grad_theta, dim=-1)
    if n_rows is not None:
        return ((norms - 1.0) ** 2).sum() / n_rows
    return ((norms - 1.0) ** 2).mean()


def mask_loss(sdf_output, network_object_mask, object_mask, alpha, n_pixels):
    """(1/alpha) * BCEWithLogits(-alpha*sdf, gt) over ~(net & obj) / ray count
    (loss.py:42-49), in the stable max(x,0) - x*y + log(1+exp(-|x|)) form."""
    mask = ~(network_object_mask & object_mask)
    logits = -alpha * sdf_output[:, 0]
    gt = object_mask.to(logits.dtype)
    bce = (torch.clamp_min(logits, 0.0) - logits * gt
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return (1.0 / alpha) * torch.where(mask, bce, torch.zeros_like(bce)).sum() / n_pixels


def idr_loss(cfg: IDRLossConfig, model_outputs: Dict[str, torch.Tensor],
             rgb_gt: torch.Tensor, alpha: float, n_rays: Optional[int] = None,
             n_eik: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The loss terms of these rays.  A rank of a sharded step passes the
    global ray count ``n_rays`` and eikonal row count ``n_eik``: its terms
    are then its share of the global ones, which sum over the ranks."""
    network_object_mask = model_outputs["network_object_mask"]
    object_mask = model_outputs["object_mask"]
    n_pixels = float(object_mask.shape[0] if n_rays is None else n_rays)
    l_rgb = rgb_loss(model_outputs["rgb_values"], rgb_gt.reshape(-1, 3),
                     network_object_mask & object_mask, n_pixels)
    l_mask = mask_loss(model_outputs["sdf_output"], network_object_mask, object_mask,
                       alpha, n_pixels)
    l_eik = eikonal_loss(model_outputs["grad_theta"], n_eik)
    total = l_rgb + cfg.eikonal_weight * l_eik + cfg.mask_weight * l_mask
    return {"loss": total, "rgb_loss": l_rgb, "eikonal_loss": l_eik, "mask_loss": l_mask}
