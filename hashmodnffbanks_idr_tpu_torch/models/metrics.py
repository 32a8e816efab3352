"""Image quality metrics: masked PSNR, SSIM, (gated) LPIPS, Chamfer.

Parity with code/model/metrics.py:1-87:
  * :func:`masked_psnr` — PSNR over mask pixels on [-1,1] images scaled to
    [0,1] (metrics.py:26-33 computes MSE over masked pixels).
  * :func:`ssim` — standard Gaussian-window SSIM (11x11, sigma 1.5), matching
    torchmetrics defaults used by the reference (metrics.py:36-44).
  * :func:`lpips_or_none` — the reference uses AlexNet LPIPS (metrics.py:47-54);
    here backed by the port's torch implementation in models/lpips.py
    (official weights when available, documented deterministic fallback
    otherwise).
  * :func:`chamfer_distance` — two-sided nearest-neighbour Chamfer via scipy
    cKDTree (replaces pytorch3d, metrics.py:56-87).

A copy of ``hashmodnffbanks_idr_tpu/models/metrics.py`` except that
:func:`lpips_or_none` takes the device LPIPS runs on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def masked_psnr(img: np.ndarray, gt: np.ndarray, mask: np.ndarray,
                data_range: float = 2.0) -> float:
    """img/gt in [-1,1], (..., 3); mask broadcastable to pixel shape."""
    mask = mask.astype(bool)
    if mask.sum() == 0:
        return float("nan")
    diff = (img - gt)[mask]
    mse = float(np.mean(diff**2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2 * sigma**2))
    return k / k.sum()


def ssim(img: np.ndarray, gt: np.ndarray, data_range: float = 2.0) -> float:
    """(H, W, C) images; Gaussian 11x11 sigma 1.5 (torchmetrics defaults)."""
    from scipy.ndimage import convolve1d

    k = _gaussian_kernel()

    def blur(x):
        x = convolve1d(x, k, axis=0, mode="reflect")
        return convolve1d(x, k, axis=1, mode="reflect")

    img = img.astype(np.float64)
    gt = gt.astype(np.float64)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu_x = blur(img)
    mu_y = blur(gt)
    sigma_x = blur(img**2) - mu_x**2
    sigma_y = blur(gt**2) - mu_y**2
    sigma_xy = blur(img * gt) - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x**2 + mu_y**2 + C1) * (sigma_x + sigma_y + C2)
    return float(np.mean(num / den))


def lpips_or_none(img: np.ndarray, gt: np.ndarray, device=None) -> Optional[float]:
    """AlexNet LPIPS via the port's torch implementation (models/lpips.py),
    on ``device`` (None -> the CUDA card).

    Uses official weights when ``HMNFFB_LPIPS_WEIGHTS`` provides them,
    otherwise the documented deterministic fallback — always finite offline.
    Returns None only if the images are too small for the AlexNet trunk."""
    from .lpips import lpips as _lpips

    try:
        return _lpips(img, gt, device=device)
    except ValueError:
        return None


def chamfer_distance(p1: np.ndarray, p2: np.ndarray) -> dict:
    """Two-sided mean nearest-neighbour distances (d2s/s2d/overall)."""
    from scipy.spatial import cKDTree

    d12 = cKDTree(p2).query(p1, k=1)[0]
    d21 = cKDTree(p1).query(p2, k=1)[0]
    return {
        "d2s": float(d12.mean()),
        "s2d": float(d21.mean()),
        "overall": float((d12.mean() + d21.mean()) / 2.0),
    }
