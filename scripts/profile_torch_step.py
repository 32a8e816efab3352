#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time on the card, the
step replayed from CUDA graphs beside the eager one.

    python3 scripts/profile_torch_step.py [--steps 3] [--cells flagship|ngp|all|five]
        [--variants graphed,eager]

For each cell of chip_smoke.py (the flagship in exact+fused, mixed, fast and
exact unfused; the bench.py ngp presets of ``testing.NGP_PRESETS`` in
exact+fused and mixed; ``five`` is the flagship's four and ngp log2=15
mixed) it runs each variant of the step (``build_train_step(graphed=...)``)
in turns, "a" in the order given and "b" in the reverse order, each from
the same weights and generator with only its own model alive: the first
call (the graphed step's warm-up, capture and assembly), two more, then
``--steps`` measured steps (see ``measure``), then as many steps counted
(``count``: graph launches, each loop's iterations and the host's
synchronisations per step), and in each cell's first run the tracer alone
(eager) as many times.  One JSON line per cell and variant run.  Needs one
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import statistics
import subprocess
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
from hashmodnffbanks_idr_tpu_torch.utils import graphs  # noqa: E402
from hashmodnffbanks_idr_tpu_torch.utils.profiling import host_syncs, trace  # noqa: E402
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
FIVE = ("exact+fused", "mixed", "fast", "exact (unfused)", "ngp log2=15 mixed")
# host calls that put work on the card: a kernel, a graph replay, a copy or
# a fill; a graph replay counts as one
HOST_LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch|cudaGraphLaunch|cuGraphLaunch|"
                         r"cudaMemcpyAsync|cudaMemsetAsync)")


def measure(fn, reps: int) -> dict:
    """Wall ms of each of ``reps`` calls of ``fn`` (each ending in a
    synchronise: median, min, max), then the same calls under
    ``torch.profiler``: device-busy ms (the sum of kernel times), the
    device's idle share against the unprofiled median, the host's launches
    (kernels, graph replays, copies and fills; a replay counts one), the
    graph replays, the kernels the device ran (inside replays too), host
    waits on the device (``cudaStreamSynchronize``: a device-to-host read
    such as a tracer loop's predicate), the fused SDF-MLP kernels' device ms
    and launches by variant and by ``<K0, C>``, and the largest kernels, all
    per call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(times)
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
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    fused = {}
    for e in kernels:
        m = re.search(r"(f32|bf16k)::fused_sdf_kernel<([^>]*)>", e.key)
        if m:
            rec = fused.setdefault(m.group(1), {"ms": 0.0, "launches": 0, "by_args": {}})
            rec["ms"] += e.self_device_time_total / 1e3 / reps
            rec["launches"] += e.count / reps
            rec["by_args"][m.group(2).replace(" ", "")] = {
                "ms": e.self_device_time_total / 1e3 / reps, "launches": e.count / reps}
    host = [e for e in events if e.device_type == DeviceType.CPU and HOST_LAUNCH.match(e.key)]
    return {"wall_ms": wall_ms, "wall_ms_min": min(times), "wall_ms_max": max(times),
            "wall_ms_under_profiler": prof_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "host_launches": sum(e.count for e in host) / reps,
            "graph_replays": sum(e.count for e in host if "GraphLaunch" in e.key) / reps,
            "device_kernels": sum(e.count for e in kernels) / reps,
            "device_syncs": sum(e.count for e in events
                                if e.key == "cudaStreamSynchronize") / reps,
            "fused_sdf_kernels": fused,
            "top_kernels_ms": [[e.key[:120], e.self_device_time_total / 1e3 / reps]
                               for e in top]}


def count(fn, step, reps: int) -> dict:
    """Per call of ``fn`` over ``reps`` calls: the graphed step's graph
    launches, each loop's iterations (``graphs.loop_iterations``: the
    device totals of a graph, folded in after the calls, or the eager
    loop's host counts) and the host's synchronisations inside the calls."""
    program = getattr(step, "program", None)
    launched = program.launches if program is not None else 0
    graphs.fold_device_counts()
    before = dict(graphs.loop_iterations)
    torch.cuda.synchronize()
    with host_syncs() as syncs:
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    graphs.fold_device_counts()
    return {"graph_launches_per_step": ((program.launches - launched) / reps
                                        if program is not None else 0),
            "loop_iterations_per_step": {k: (v - before.get(k, 0)) / reps
                                         for k, v in graphs.loop_iterations.items()
                                         if v != before.get(k, 0)},
            "host_syncs_per_step": syncs[0] / reps}


def run_variant(dev, scene, conf, graphed: bool, steps: int, with_tracer: bool) -> dict:
    model = IDRNetwork(conf.get_config("model"), device=dev, seed=0)
    step = build_train_step(model, IDRLossConfig(0.1, 200.0, 50.0), make_optimizer(model),
                            graphed=graphed)
    gen = torch.Generator(device=dev).manual_seed(1)
    img_idx = torch.tensor([0], device=dev)
    total = IMG_RES[0] * IMG_RES[1]

    def train_step():
        step(scene, img_idx, sample_pixels(gen, total, N_RAYS), gen, 50.0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(2):
        train_step()
    rec = {"graphed": graphed, "first_call_ms": first_ms,
           "capture_s": getattr(step, "capture_s", None),
           "graphs": step.program.graphs() if graphed else None,
           "step": measure(train_step, steps),
           "counted": count(train_step, step, steps),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "reserved_mib": torch.cuda.memory_reserved() / 2**20}
    if with_tracer:
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

        rec["tracer"] = measure(tracer, steps)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cells", choices=("flagship", "ngp", "all", "five"), default="flagship")
    ap.add_argument("--variants", default="graphed,eager")
    args = ap.parse_args()
    dev = resolve_device(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}))
    scene = scene_to_device(synthetic_scene(n_views=2, img_res=IMG_RES, seed=0), dev)
    variants = [v == "graphed" for v in args.variants.split(",")]
    for label, preset, mode, fused in CELLS:
        if args.cells == "five" and label not in FIVE:
            continue
        if args.cells in ("flagship", "ngp") and (preset is None) != (args.cells == "flagship"):
            continue
        conf = flagship_conf(num_pixels=N_RAYS) if preset is None else ngp_conf(preset, N_RAYS)
        conf.put("model.tracer_fast", mode)
        conf.put("model.tracer_exact_fused", fused)
        for turn, order in (("a", variants), ("b", variants[::-1])):
            for j, graphed in enumerate(order):
                rec = run_variant(dev, scene, conf, graphed, args.steps,
                                  with_tracer=turn == "a" and j == 0)
                print(json.dumps({"label": label, "turn": turn, "reps": args.steps, **rec}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
