"""Scene data helpers.

Counterpart of ``hashmodnffbanks_idr_tpu/data/scene_dataset.py``; only the
pixel conversion the train step uses is ported.  Still to port: the on-disk
``SceneDataset``.
"""

from __future__ import annotations

import torch


def rgb_to_pm1(rgb_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] float32 (rend_util.py:8-16)."""
    return (rgb_uint8.to(torch.float32) / 255.0 - 0.5) * 2.0
