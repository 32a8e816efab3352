"""Uniform without-replacement pixel sampling.

Counterpart of ``hashmodnffbanks_idr_tpu/utils/sampling.py``: the role of the
reference's per-epoch ``torch.randperm(total_pixels)[:n]``
(scene_dataset.py:113-117), a uniformly random n-subset of the pixel grid in
uniformly random order.  On the card ``randperm`` is cheap, so the JAX
package's oversample-and-dedupe trick is not needed.
"""

from __future__ import annotations

import torch


def sample_pixels(generator: torch.Generator, total: int, n: int) -> torch.Tensor:
    """Uniform random n-subset of range(total), in uniform random order, on
    the generator's device."""
    return torch.randperm(total, generator=generator, device=generator.device)[:n]
