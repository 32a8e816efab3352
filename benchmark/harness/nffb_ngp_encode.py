"""The least time of the NFFB encode kernel on the instant-ngp grid
(``nffb_encode_kernel<NgpGrid, ...>`` in the port's ``ops/csrc/nffb_encode.cu``): the
yardstick of ``nffb_ngp_encode_roofline``.

Computed from widths and counts, never from what ran.  For an FFBTcnn
encoder of L levels of F features (out width W = (2 + 2L) F, style
modulation, the SIREN trunk's L - 1 layers, the out layer) the kernel's
work a point is that of the USED = L - 2 levels that its output reads:

  * multiply-adds: each used level's 8 cell corners, their trilinear weight
    (IN - 1 products) and their share of the F features' weighted sum; the
    style transform (W x W a used level); the trunk (IN x W, then
    (L - 2) x W x W); the out layer (W x W);
  * bytes: the point's IN floats in and its output row (IN + W floats) out.

A launch reads, besides, the weights it multiplies by (the style transform,
the trunk and the out layer with their biases) and the used levels' table
rows (F floats a row; each level's rows as the instant-ngp grid sizes them:
(resolution + 1)^IN, at most 2^log2, rounded up to 8).  The least time is
the larger of the multiply-adds at the H100 SXM's FP32 FMA peak (67
TFLOP/s, NVIDIA's data sheet) and the bytes at 3.35 TB/s."""

from __future__ import annotations

import math
from typing import Dict, List

IN = 3
CORNERS = 1 << IN
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def out_width(levels: int, features: int) -> int:
    return (2 + 2 * levels) * features


def level_rows(levels: int, log2_rows: int, base_resolution: int,
               desired_resolution: int) -> List[int]:
    """Each level's table rows on the instant-ngp grid."""
    growth = 2.0 ** (math.log2(desired_resolution / base_resolution) / (levels - 1))
    rows = []
    for l in range(levels):
        res = math.ceil(base_resolution * growth ** l)
        n = min(2 ** log2_rows, (res + 1) ** IN)
        rows.append(-(-n // 8) * 8)
    return rows


def macs_per_point(levels: int, features: int, style: bool = True) -> int:
    w, used = out_width(levels, features), levels - 2
    grid = used * CORNERS * ((IN - 1) + features)
    style_macs = used * w * w if style else 0
    trunk = IN * w + (levels - 2) * w * w
    return grid + style_macs + trunk + w * w


def weight_bytes(levels: int, features: int, style: bool = True) -> int:
    w = out_width(levels, features)
    floats = (IN * w + w) + (levels - 2) * (w * w + w) + (w * w + w)
    if style:
        floats += w * w + w
    return 4 * floats


def launch_bytes(levels: int, features: int, log2_rows: int, base_resolution: int,
                 desired_resolution: int, style: bool = True) -> int:
    """What a launch reads once: the weights and the used levels' rows."""
    rows = level_rows(levels, log2_rows, base_resolution, desired_resolution)[:levels - 2]
    return weight_bytes(levels, features, style) + 4 * features * sum(rows)


def bound_s(points: float, launches: float, levels: int, features: int, log2_rows: int,
            base_resolution: int, desired_resolution: int, style: bool = True) -> float:
    """The least time of ``launches`` launches over ``points`` points in
    all, summed over launches before the larger is taken."""
    ops_s = 2.0 * macs_per_point(levels, features, style) * points / PEAK_FP32_FLOPS
    nbytes = (points * 4 * (IN + IN + out_width(levels, features))
              + launches * launch_bytes(levels, features, log2_rows, base_resolution,
                                        desired_resolution, style))
    return max(ops_s, nbytes / PEAK_BYTES_PER_S)


def points_encoder(model_conf: Dict) -> Dict:
    """The SDF encoder's shape from a model conf, as the port builds it:
    ``embedding_network``'s keys over ``implicit_network``'s (levels =
    ``multires``; FFBTcnn's preset has the style block)."""
    enc = dict(model_conf.get("implicit_network", {}))
    enc.update(model_conf.get("embedding_network", {}))
    return {"levels": int(enc["multires"]), "features": int(enc["max_points_per_entry"]),
            "log2_rows": int(enc["log2_max_hash_size"]),
            "base_resolution": int(enc["base_resolution"]),
            "desired_resolution": int(enc["desired_resolution"]),
            "style": bool(enc.get("style_modulation", True))}
