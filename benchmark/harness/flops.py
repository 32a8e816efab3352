"""Operations, bytes and peaks: the yardstick of the per-layer metrics.

Everything here is computed from widths and counts, never from what ran,
so a share reads the same work whatever implements it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
989 TFLOP/s bf16, 495 TFLOP/s TF32, 3.35 TB/s HBM3.  A float32 product is
counted as three TF32 products (split-TF32, the way a float32-accurate
product reaches the tensor cores), so float32 work runs at most at 495/3
TFLOP/s.

The fused SDF-MLP (``ops/fused_mlp.py``) computes the SDF channel of the
8x512 skip-4 MLP for N embedded points: l0 d_in->512, l1..l2 512->512, l3
512->(512-d_in), the skip concat, l4..l7 512->512, l8 the SDF column.  Its
least time for a call is the larger of its products at the peak and its
bytes at the HBM rate, counting each input point and each weight read once
a launch and each output written once."""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
TF32_PRODUCTS_PER_F32 = 3
HIDDEN = 512
N_HIDDEN = 8           # SDF MLP hidden layers, l0..l7
SKIP_LAYER = 4         # the skip concat enters l4


def seconds_at_peak(flops: float, precision: str) -> float:
    """The least time of ``flops`` products in ``precision`` ('f32' or
    'bf16')."""
    if precision == "f32":
        return flops * TF32_PRODUCTS_PER_F32 / PEAK_FLOPS["tf32"]
    if precision == "bf16":
        return flops / PEAK_FLOPS["bf16"]
    raise ValueError(precision)


def mlp_macs(dims: Sequence[int], skip_in: Sequence[int] = (), out_cols: int = None) -> int:
    """Multiply-adds a point of the MLP with layer widths ``dims`` (input
    first), a layer in ``skip_in`` taking the input concatenated to it (the
    layer before it then ends ``dims[0]`` columns short); ``out_cols`` of
    the last layer's outputs (all by default)."""
    macs = 0
    n = len(dims) - 1
    for l in range(n):
        d_out = dims[l + 1] - dims[0] if l + 1 in skip_in else dims[l + 1]
        if l == n - 1 and out_cols is not None:
            d_out = out_cols
        macs += dims[l] * d_out
    return macs


def sdf_mlp_dims(d_in: int, feature_vector_size: int) -> list:
    return [d_in] + [HIDDEN] * N_HIDDEN + [1 + feature_vector_size]


def fused_mlp_macs(d_in: int) -> int:
    """Multiply-adds a point of the fused kernel (the SDF column only)."""
    return mlp_macs(sdf_mlp_dims(d_in, 0), (SKIP_LAYER,), out_cols=1)


def fused_mlp_weight_bytes(d_in: int, precision: str) -> int:
    """The weights a launch reads: the products' weights in the weight type,
    the biases in float32."""
    elem = 4 if precision == "f32" else 2
    biases = (N_HIDDEN * HIDDEN + 1) * 4
    return fused_mlp_macs(d_in) * elem + biases


def fused_mlp_bound_s(precision: str, points: int, launches: int, d_in: int) -> float:
    """The least time of ``launches`` launches over ``points`` points in all:
    the larger of the products at the peak and the bytes at the HBM rate.
    Summed over launches before the larger is taken, so that counts folded
    over a window give a bound no larger than the launches' own."""
    ops_s = seconds_at_peak(2.0 * fused_mlp_macs(d_in) * points, precision)
    nbytes = points * (d_in * 4 + 4) + launches * fused_mlp_weight_bytes(d_in, precision)
    return max(ops_s, nbytes / PEAK_BYTES_PER_S)


def sweep_stride(n_steps: int, guided_coarse: bool) -> int:
    """The hierarchical sweep's coarse stride on the card, as the tracer
    picks it (``models/ray_tracing.py:sweep_stride``), or 0 for the dense
    sweep."""
    cands = (9, 8, 10, 7, 11, 6, 12, 5, 4, 3)
    valid = [s for s in cands if n_steps > 2 * s and (n_steps - 1) % s == 0]
    if not valid:
        return 0
    if guided_coarse:
        return min(valid, key=lambda s: ((n_steps - 1) // s + 1) * 0.4 + 3 * (s - 1))
    return valid[0]


def tracer_guides(model_conf: Dict) -> Dict[str, bool]:
    """Which of the tracer's stages run on a guidance SDF for this model
    conf (``models/renderer.py:_tracer_sdfs``): the march's phase A, the
    sweep's coarse probes, the first secant iterations."""
    rt = model_conf["ray_tracer"]
    mode = model_conf.get("tracer_fast", "exact")
    mode = {True: "fast", False: "exact"}.get(mode, mode)
    embed = model_conf.get("embedding_network", {}).get("embed_type", "")
    prunable = embed in ("HashGridTcnn", "HashGridCUDA", "MultiResHashEncoderCUDA")
    pl_m, pl_c = int(rt.get("prune_levels_march", 0)), int(rt.get("prune_levels_coarse", 0))
    prune = (pl_m > 0 or pl_c > 0) and prunable
    march = mode == "mixed" or (prune and pl_m > 0)
    coarse = mode == "mixed" or (prune and pl_c > 0)
    secant = (march or coarse) and int(rt.get("prune_secant_iters", 0)) > 0
    return {"march": march, "coarse": coarse, "secant": secant}


def tracer_points(model_conf: Dict, rays: int, march_iters: int, line_iters: int) -> int:
    """SDF points the tracer evaluates for ``rays`` rays (every lane of
    every call; ``models/ray_tracing.py``): each march (two with a phase-A
    guide) evaluates both ends of every ray at its start, after each of its
    ``march_iters`` iterations and each of its ``line_iters`` line-search
    iterations (both summed over the marches, the device's loop counts);
    the sweep its coarse and fine probes (and the five exact endpoint slots
    when the coarse probes are guided); the secant one point a ray an
    iteration, and with guided iterations one exact call on both ends."""
    rt = model_conf["ray_tracer"]
    guides = tracer_guides(model_conf)
    n_marches = 2 if guides["march"] else 1
    pts = 2 * rays * (n_marches + march_iters + line_iters)
    n = int(rt.get("n_steps", 100))
    stride = sweep_stride(n, guides["coarse"]) if rt.get("hierarchical_sweep", True) else 0
    if stride:
        pts += rays * ((n - 1) // stride + 1 + 3 * (stride - 1) + (5 if guides["coarse"] else 0))
    else:
        pts += rays * n
    n_sec = int(rt.get("n_secant_steps", 8))
    pts += rays * n_sec
    if guides["secant"] and min(int(rt.get("prune_secant_iters", 0)), n_sec) > 0:
        pts += 2 * rays
    return pts


def train_path_macs(d_in: int, feature_vector_size: int, rendering_dims: Sequence[int],
                    rays: int) -> int:
    """Multiply-adds of the train path's differentiable points, a step
    (``models/renderer.py:forward`` and the loss's backward), counting no
    recomputed product: a forward whose outputs reach the loss costs three
    forwards (itself, and the gradients of its inputs and weights); a
    spatial gradient that reaches the loss costs six (its forward and its
    input gradient, each differentiated again).
      * the SDF at the surface points (R points, the SDF column): 3 F(1);
      * the spatial gradient at the surface points and the R/2 eikonal
        samples, for the eikonal term: 6 F(1);
      * the colour: the SDF MLP's forward at the differentiable points with
        its 256 features, 3 F(257), the normals' input gradient on that
        forward, differentiated again, 3 F(1); the rendering MLP, 3 F_r."""
    f1 = mlp_macs(sdf_mlp_dims(d_in, feature_vector_size), (SKIP_LAYER,), out_cols=1)
    f_all = mlp_macs(sdf_mlp_dims(d_in, feature_vector_size), (SKIP_LAYER,))
    f_r = mlp_macs(rendering_dims)
    eik = rays // 2
    return (3 * f1 * rays + 6 * f1 * (rays + eik) + 3 * f_all * rays + 3 * f1 * rays
            + 3 * f_r * rays)


def step_seconds_at_peak(d_in: int, feature_vector_size: int, rendering_dims: Sequence[int],
                         rays: int, tracer_pts: float, tracer_bf16_pts: float) -> float:
    """The least time of a step's matrix products: the tracer's bf16
    queries at the bf16 peak, its other queries and the train path in
    float32."""
    q = 2.0 * fused_mlp_macs(d_in)
    f32_flops = q * (tracer_pts - tracer_bf16_pts) + 2.0 * train_path_macs(
        d_in, feature_vector_size, rendering_dims, rays)
    return seconds_at_peak(f32_flops, "f32") + seconds_at_peak(q * tracer_bf16_pts, "bf16")
