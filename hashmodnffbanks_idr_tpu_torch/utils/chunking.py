"""Fixed-size tiling of full-image inference.

Counterpart of ``hashmodnffbanks_idr_tpu/utils/chunking.py`` (the
reference's split_input/merge_output, utils/general.py:23-50).
``iter_pixel_tiles`` is a copy.  ``render_in_tiles`` runs on tensors: each
tile's outputs stay on the device and the merged image is read back once.
Torch compiles nothing per shape, so the last tile is not padded.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def iter_pixel_tiles(total_pixels: int, tile: int = 10000):
    """Yield (start, size, pad) so that start:start+size tiles cover the image
    and `size + pad == tile` always."""
    for start in range(0, total_pixels, tile):
        size = min(tile, total_pixels - start)
        yield start, size, tile - size


def render_in_tiles(
    render_fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
    inputs: Dict[str, torch.Tensor],
    total_pixels: int,
    tile: int = 10000,
) -> Dict[str, np.ndarray]:
    """Run a per-tile render function over the full pixel grid.

    ``inputs`` has 'uv' (B, HW, 2) and 'object_mask' (B, HW); other entries
    pass through untouched.  ``render_fn`` returns ray-flattened tensors,
    (size,) or (size, C); they are detached, concatenated on the device and
    copied to the host once.
    """
    outs = []
    for start, size, _ in iter_pixel_tiles(total_pixels, tile):
        tile_inputs = dict(inputs)
        tile_inputs["uv"] = inputs["uv"][:, start:start + size]
        tile_inputs["object_mask"] = inputs["object_mask"][:, start:start + size]
        outs.append({k: v.detach() for k, v in render_fn(tile_inputs).items()})
    return {k: torch.cat([o[k] for o in outs], dim=0).cpu().numpy() for k in outs[0]}
