#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time on the card.

    python3 scripts/profile_torch_step.py [--steps 2] [--cells flagship|ngp|all]

For each cell of chip_smoke.py (the flagship in exact+fused, mixed, fast and
exact unfused; the bench.py ngp presets of ``testing.NGP_PRESETS`` in
exact+fused and mixed) it runs two warm-up steps, then measures ``--steps``
training steps and as many runs of the tracer alone (see ``measure``), and
prints one JSON line per cell.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hashmodnffbanks_idr_tpu_torch import resolve_device  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.geometry.cameras import get_camera_params  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.models.loss import IDRLossConfig  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.models.ray_tracing import ray_trace  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.models.renderer import IDRNetwork  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.testing import (flagship_conf, ngp_conf,  # noqa: E402
                                                   scene_to_device, synthetic_scene)
from hashmodnffbanks_idr_tpu_torch.train.trainer import (build_train_step,  # noqa: E402
                                                         make_optimizer)
from hashmodnffbanks_idr_tpu_torch.utils.profiling import trace  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.utils.sampling import sample_pixels  # noqa: E402

N_RAYS, IMG_RES = 2048, (1200, 1600)
# (label, ngp preset or None for the flagship, tracer_fast, tracer_exact_fused)
CELLS = (("exact+fused", None, "exact", True), ("mixed", None, "mixed", False),
         ("fast", None, "fast", False), ("exact (unfused)", None, "exact", False),
         ("ngp log2=15 exact+fused", "ngp_log2_15", "exact", True),
         ("ngp log2=15 mixed", "ngp_log2_15", "mixed", False),
         ("ngp log2=19 mixed", "ngp_log2_19", "mixed", False),
         ("ngp K=3 exact+fused", "ngp_log2_15_k3", "exact", True),
         ("ngp K=3 mixed", "ngp_log2_15_k3", "mixed", False))


def measure(fn, reps: int) -> dict:
    """Wall ms per call of ``fn`` (``reps`` calls ending in a synchronise),
    then the same under ``torch.profiler``: device-busy ms (the sum of kernel
    times), the device's idle share against the unprofiled wall time, kernel
    launches, host waits on the device (``cudaStreamSynchronize``: a
    device-to-host read such as the tracer's ``.any()`` loop tests) and the
    largest kernels, all per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with trace() as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.key_averages()
    # device kernels only: a record_function range (Adam's step) also shows
    # on the device timeline, as a user annotation over kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {"wall_ms": wall_ms, "wall_ms_under_profiler": prof_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels) / reps,
            "device_syncs": sum(e.count for e in events
                                if e.key == "cudaStreamSynchronize") / reps,
            "top_kernels_ms": [[e.key[:120], e.self_device_time_total / 1e3 / reps]
                               for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--cells", choices=("flagship", "ngp", "all"), default="flagship")
    args = ap.parse_args()
    dev = resolve_device(None)
    scene = scene_to_device(synthetic_scene(n_views=2, img_res=IMG_RES, seed=0), dev)
    total = IMG_RES[0] * IMG_RES[1]
    for label, preset, mode, fused in CELLS:
        if args.cells != "all" and (preset is None) != (args.cells == "flagship"):
            continue
        conf = flagship_conf(num_pixels=N_RAYS) if preset is None else ngp_conf(preset, N_RAYS)
        conf.put("model.tracer_fast", mode)
        conf.put("model.tracer_exact_fused", fused)
        model = IDRNetwork(conf.get_config("model"), device=dev, seed=0)
        step = build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), make_optimizer(model))
        gen = torch.Generator(device=dev).manual_seed(1)
        img_idx = torch.tensor([0], device=dev)

        def train_step():
            step(scene, img_idx, sample_pixels(gen, total, N_RAYS), gen, 50.0)

        # the tracer alone, on one fixed batch of the step's rays
        pix = sample_pixels(gen, total, N_RAYS)
        dirs, cam = get_camera_params(scene["uv"][pix][None], scene["pose"][img_idx],
                                      scene["intrinsics"][img_idx])
        mask = scene["mask"][img_idx][:, pix].reshape(-1)

        @torch.no_grad()
        def tracer():
            sdf, guidance = model._tracer_sdfs()
            ray_trace(model.ray_tracer, sdf, cam, mask, dirs, generator=gen,
                      sdf_guidance=guidance)

        for _ in range(2):
            train_step()
        print(json.dumps({"label": label, "reps": args.steps,
                          "step": measure(train_step, args.steps),
                          "tracer": measure(tracer, args.steps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
