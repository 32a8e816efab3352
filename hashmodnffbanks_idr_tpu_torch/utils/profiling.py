"""Profiling and roofline accounting.

Counterpart of ``hashmodnffbanks_idr_tpu/utils/profiling.py``:

  * :func:`trace`: a ``torch.profiler`` window, optionally written as a
    Chrome trace (open it in chrome://tracing or Perfetto) with its
    ``key_averages`` (``scripts/profile_torch_step.py`` measures through it);
  * :func:`host_syncs`: the host's synchronisations with the card inside a
    block, counted or refused (``chip_smoke.py``, the profile script);
  * :func:`mlp_flops` / :func:`step_flops`: the analytic FLOP model of one
    IDR train step (copies);
  * :func:`roofline_report`: a measured step time -> TFLOP/s and its share
    of an NVIDIA H100 SXM's peak (data sheet, dense, at the 700 W limit).
    The caller names the peak: the port's MLP work runs split-TF32 or bf16
    on the tensor cores and the rest float32 on the CUDA cores, so no one
    precision is right for every step.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch

from .. import resolve_device

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit): f32 on the
# CUDA cores, tf32 and bf16 on the tensor cores; HBM3 bandwidth
H100_PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
H100_PEAK_BYTES_PER_S = 3.35e12


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device=None):
    """Profile the body on ``device`` (None -> the CUDA card; 'cpu' records
    host activity only).  Yields the ``torch.profiler.profile``; on exit,
    given a ``logdir``, writes ``<logdir>/trace.json`` and
    ``<logdir>/key_averages.txt``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    if logdir is None:
        return
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "cuda_time_total" if ProfilerActivity.CUDA in activities else "cpu_time_total"
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))


@contextlib.contextmanager
def host_syncs(mode: str = "warn"):
    """Count the host's synchronisations with the card inside the block
    (``torch.cuda.set_sync_debug_mode``: "warn" counts them, "error" raises
    at the first).  Yields a one-element list that holds the count once the
    block has ended."""
    import warnings

    count = [0]
    torch.cuda.set_sync_debug_mode(mode)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield count
        count[0] = sum("synchronizing CUDA operation" in str(w.message) for w in seen)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def mlp_flops(dims, n_points: int) -> float:
    f = 0.0
    for i in range(len(dims) - 1):
        f += 2.0 * dims[i] * dims[i + 1] * n_points
    return f


def step_flops(num_pixels: int, n_steps: int = 100, sphere_iters: int = 10,
               secant_steps: int = 8, hidden: int = 512, n_hidden: int = 8,
               embed_dim: int = 59, feature: int = 256,
               hierarchical_sweep: bool = True) -> Dict[str, float]:
    """Rough forward-FLOP model of one training step (R rays)."""
    from ..models.ray_tracing import RayTracerConfig, sweep_stride

    dims = [embed_dim] + [hidden] * n_hidden + [1 + feature]
    per_pt = mlp_flops(dims, 1)
    # ONE fused sweep serves both the sampler and the min-SDF fallback
    # (models/ray_tracing.py fuses them into a single evaluation per ray) —
    # counted once, not per consumer.  With the hierarchical sweep the grid
    # is probed at n_c coarse + 3(s-1) refined points instead of densely.
    stride = sweep_stride(RayTracerConfig(n_steps=n_steps, hierarchical_sweep=hierarchical_sweep),
                          guided_coarse=False, on_cuda=False)
    if stride is not None:
        sweep_evals = (n_steps - 1) // stride + 1 + 3 * (stride - 1)
    else:
        sweep_evals = n_steps
    sweep_pts = num_pixels * sweep_evals
    trace_pts = num_pixels * (2 * sphere_iters + secant_steps + 8)
    train_pts = num_pixels * 2 + num_pixels // 2  # sdf+grad sites
    fwd = per_pt * (sweep_pts + trace_pts)
    train = per_pt * train_pts * 6              # fwd+bwd+2nd order ~6x
    return {
        "tracer_fwd_flops": fwd,
        "train_path_flops": train,
        "total_flops": fwd + train,
    }


def roofline_report(step_time_s: float, num_pixels: int, peak: str,
                    **kw) -> Dict[str, float]:
    """``step_flops`` over a measured step time, against the H100 SXM's
    ``peak`` ('f32', 'tf32' or 'bf16')."""
    f = step_flops(num_pixels, **kw)
    achieved = f["total_flops"] / step_time_s / 1e12
    return {
        "step_time_ms": step_time_s * 1e3,
        "rays_per_s": num_pixels / step_time_s,
        "achieved_tflops": achieved,
        "peak": peak,
        "peak_tflops": H100_PEAK_FLOPS[peak] / 1e12,
        "peak_fraction": achieved / (H100_PEAK_FLOPS[peak] / 1e12),
        **{k: v / 1e9 for k, v in f.items()},
    }
